"""The pieces of the port's pretraining stages against the JAX package, on
the CPU: the two kernels' plain backwards against JAX's VJPs (the cost
volume's `_cost_volume_xla`, the warp's `_warp_quad`), the autograd
Functions that carry them, the synthetic scenes, the boundary band, the
multiscale EPE, the box masks, one recover pretraining step from JAX's
initial weights, JAX's working-resolution flow and JAX's box draws (the
loss and the clipped gradients), the learning-rate schedule, the Adam
update and the flax initialisers.

Tolerances, fixed before the first run:
* backward vs JAX VJP, float32: 1e-5 of each output's largest |element|
  (sums of up to 81 products, or 4 scattered taps, in other orders);
* synthetic scenes: 1e-6 absolute (the textures' linear upsample in
  PyTorch vs jax.image.resize, 1.2e-7 apart on a test base; flows and the
  warp are the same float operations);
* multiscale EPE and the Adam update: 1e-6 relative (float32 means and
  elementwise updates in other orders);
* boundary band and box masks: equal (comparisons and max/min of {0, 1}).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_parity import clamp_flow, torch_threads
from unsupervised_detection_tpu.config import Config as JaxConfig
from unsupervised_detection_tpu.ops.cost_volume import _cost_volume_xla
from unsupervised_detection_tpu.ops.losses import charbonnier_loss as jax_charbonnier
from unsupervised_detection_tpu.ops.warp import _warp_quad
from unsupervised_detection_tpu.train import pretrain as jax_pretrain
from unsupervised_detection_tpu.train import pretrain_pwc as jax_pwc
from unsupervised_detection_tpu.train.objective import AdversarialObjective as JaxObjective
from unsupervised_detection_tpu_torch import Config, convert
from unsupervised_detection_tpu_torch.models.layers import (TRUNCATED_NORMAL_STD,
                                                            ConvTranspose2D, GenConv, PWCConv)
from unsupervised_detection_tpu_torch.ops.cost_volume import (
    cost_volume, cost_volume_backward, cost_volume_backward_plain, cost_volume_plain)
from unsupervised_detection_tpu_torch.ops.warp import (dense_image_warp, warp_backward,
                                                       warp_backward_plain)
from unsupervised_detection_tpu_torch.train import optim
from unsupervised_detection_tpu_torch.train.pretrain import RecoverPretrainer, random_box_masks
from unsupervised_detection_tpu_torch.train.pretrain_pwc import (boundary_band, multiscale_epe,
                                                                 synthetic_flow_batch)



_threads = torch_threads(1)


VJP_REL = 1e-5
SCENE_ATOL = 1e-6
EPE_RTOL = 1e-6
ADAM_RTOL = 1e-6
# one recover pretraining step: the loss within 1e-5 relative (float32 sums
# over 4k pixels in other orders), every clipped gradient element within
# 1e-4 of its tensor's largest (the backward of ~30 float32 convolutions,
# oneDNN against XLA)
STEP_LOSS_RTOL, STEP_GRAD_OF_LARGEST = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_of_largest(got, want, rel=VJP_REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    top = max(np.abs(want).max(), 1e-30)
    gap = np.abs(got - want).max()
    assert gap <= rel * top, f"{what}: max gap {gap} = {gap / top} of the largest {top}"


def _warp_inputs(shape, flow_kind, seed):
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    image = rs.randn(b, h, w, c).astype(np.float32)
    flow = (np.zeros((b, h, w, 2), np.float32) if flow_kind == "zero"
            else clamp_flow(rs, b, h, w))
    return image, flow, rs.randn(b, h, w, c).astype(np.float32)


@jax.jit
def _warp_vjp_jit(image, flow, g):
    return jax.vjp(_warp_quad, image, flow)[1](g)


def _jax_warp_vjp(image, flow, g):
    return [np.asarray(x) for x in _warp_vjp_jit(image, flow, g)]


def _cost_inputs(shape, r, seed):
    """c1 and warp with exact zeros: two zero pixels of c1 and a zero patch
    of warp give costs of exactly 0, where JAX's leaky_relu passes the
    gradient with slope 1 (torch's F.leaky_relu would pass 0.1)."""
    rs = np.random.RandomState(seed)
    c1 = rs.randn(*shape).astype(np.float32)
    warp = rs.randn(*shape).astype(np.float32)
    c1[0, 1, 2] = 0.0
    c1[-1, -2, -3] = 0.0
    warp[0, 2:5, 3:7] = 0.0
    k = (2 * r + 1) ** 2
    g = rs.randn(*shape[:3], k).astype(np.float32)
    return c1, warp, g


@functools.partial(jax.jit, static_argnums=3)
def _cost_vjp_jit(c1, warp, g, r):
    return jax.vjp(lambda a, b: _cost_volume_xla(a, b, r), c1, warp)[1](g)


def _jax_cost_vjp(c1, warp, g, r):
    return [np.asarray(x) for x in _cost_vjp_jit(c1, warp, g, r)]


# --- the plain backwards against JAX's VJPs ----------------------------------
@pytest.mark.parametrize("flow_kind", ["clamp", "zero"])
@pytest.mark.parametrize("c", [1, 3, 32])
def test_warp_backward_plain_matches_jax_vjp(c, flow_kind):
    # "clamp": sources past every edge, integer and fractional; "zero":
    # every fraction exactly 0 (the last row and column exactly 1), where
    # jnp.clip's gradient is 0.5
    image, flow, g = _warp_inputs((2, 9, 12, c), flow_kind, seed=c)
    want_image, want_flow = _jax_warp_vjp(image, flow, g)
    got_image, got_flow = warp_backward_plain(_t(image), _t(flow), _t(g))
    assert got_image.dtype == got_flow.dtype == torch.float32
    _close_of_largest(got_image.numpy(), want_image, what="g_image")
    _close_of_largest(got_flow.numpy(), want_flow, what="g_flow")
    if flow_kind == "zero":
        assert np.abs(want_flow).max() > 0.0       # the half-gradient rule shows


@pytest.mark.parametrize("c", [1, 3, 32])
@pytest.mark.parametrize("r", [2, 4])
def test_cost_volume_backward_plain_matches_jax_vjp(r, c):
    c1, warp, g = _cost_inputs((2, 7, 11, c), r, seed=10 * r + c)
    out = cost_volume_plain(_t(c1), _t(warp), r)
    assert (out == 0).any()                           # the slope-1 rule is exercised
    want_c1, want_warp = _jax_cost_vjp(c1, warp, g, r)
    got_c1, got_warp = cost_volume_backward_plain(_t(c1), _t(warp), out, _t(g), r)
    _close_of_largest(got_c1.numpy(), want_c1, what="g_c1")
    _close_of_largest(got_warp.numpy(), want_warp, what="g_warp")
    # at a zero pixel of c1 every cost is exactly 0: torch's slope (0.1)
    # there would be off by 10x
    slope_01 = cost_volume_backward_plain(_t(c1), _t(warp), out - (out == 0).float(),
                                          _t(g), r)[0].numpy()
    assert np.abs(slope_01[0, 1, 2] - want_c1[0, 1, 2]).max() > 1e-3


# --- the autograd Functions on the CPU ---------------------------------------
@pytest.mark.parametrize("flow_kind", ["clamp", "zero"])
def test_warp_function_gradient_is_jax_vjp(flow_kind):
    image, flow, g = _warp_inputs((2, 8, 10, 5), flow_kind, seed=3)
    want_image, want_flow = _jax_warp_vjp(image, flow, g)
    ti, tf = _t(image).requires_grad_(), _t(flow).requires_grad_()
    before = (dense_image_warp.launches, warp_backward.launches)
    out = dense_image_warp(ti, tf)
    assert out.grad_fn is not None
    out.backward(_t(g))
    _close_of_largest(ti.grad.numpy(), want_image, what="g_image")
    _close_of_largest(tf.grad.numpy(), want_flow, what="g_flow")
    assert (dense_image_warp.launches, warp_backward.launches) == before


@pytest.mark.parametrize("r", [2, 4])
def test_cost_volume_function_gradient_is_jax_vjp(r):
    c1, warp, g = _cost_inputs((2, 6, 9, 16), r, seed=r)
    want_c1, want_warp = _jax_cost_vjp(c1, warp, g, r)
    ta, tb = _t(c1).requires_grad_(), _t(warp).requires_grad_()
    before = (cost_volume.launches, cost_volume_backward.launches)
    out = cost_volume(ta, tb, r)
    assert out.grad_fn is not None
    out.backward(_t(g))
    _close_of_largest(ta.grad.numpy(), want_c1, what="g_c1")
    _close_of_largest(tb.grad.numpy(), want_warp, what="g_warp")
    assert (cost_volume.launches, cost_volume_backward.launches) == before


@pytest.mark.parametrize("which", ["warp", "cost_volume"])
def test_functions_pass_gradcheck_float64(which):
    # float64 throughout (the plain versions keep float64 coordinates);
    # the flow stays 0.2 px or more off integer coordinates, where the
    # bilinear warp is smooth
    rs = np.random.RandomState(5)
    if which == "warp":
        image = torch.from_numpy(rs.randn(1, 5, 6, 3)).requires_grad_()
        base = rs.uniform(-2.0, 2.0, size=(1, 5, 6, 2))
        frac = rs.uniform(0.2, 0.8, size=base.shape)
        flow = torch.from_numpy(np.floor(base) + frac).requires_grad_()
        assert torch.autograd.gradcheck(dense_image_warp, (image, flow))
    else:
        a = torch.from_numpy(rs.randn(1, 4, 5, 3)).requires_grad_()
        b = torch.from_numpy(rs.randn(1, 4, 5, 3)).requires_grad_()
        assert torch.autograd.gradcheck(lambda x, y: cost_volume(x, y, 2), (a, b))


def test_second_derivative_raises():
    image = torch.randn(1, 4, 5, 2, requires_grad=True)
    flow = (0.3 * torch.randn(1, 4, 5, 2)).requires_grad_()
    for out, inputs in ((dense_image_warp(image, flow), (image, flow)),
                        (cost_volume(image, image, 2), (image,))):
        grads = torch.autograd.grad(out.square().sum(), inputs, create_graph=True)
        with pytest.raises(RuntimeError):
            torch.autograd.grad(sum(g.sum() for g in grads), inputs)


def test_backward_wrappers_refuse_other_devices():
    meta = torch.empty(1, 4, 6, 8, device="meta")
    with pytest.raises(ValueError):
        cost_volume_backward(meta, meta, torch.empty(1, 4, 6, 25, device="meta"),
                             torch.empty(1, 4, 6, 25, device="meta"), 2)
    with pytest.raises(ValueError):
        warp_backward(meta, torch.empty(1, 4, 6, 2, device="meta"), meta)


# --- pieces of the PWC stage -------------------------------------------------
def test_synthetic_flow_batch_matches_jax():
    want = jax_pwc.synthetic_flow_batch(np.random.RandomState(7), 2, 64, 128, max_mag=12.0)
    got = synthetic_flow_batch(np.random.RandomState(7), 2, 64, 128, max_mag=12.0,
                               device="cpu")
    for name, g, w in zip(("img1", "img2", "flow"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=SCENE_ATOL, err_msg=name)
    # the flows are the same float operations: equal
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_boundary_band_equals_jax():
    rs = np.random.RandomState(8)
    mask = np.zeros((2, 24, 32, 1), np.float32)
    mask[0, 3:12, 5:20] = 1.0
    mask[1] = (rs.rand(24, 32, 1) > 0.8).astype(np.float32)
    mask[1, :, :3] = 1.0                                  # touches the border
    got = boundary_band(_t(mask)).numpy()
    want = np.asarray(jax_pwc.boundary_band(jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)


def _epe_inputs(seed):
    """A 64x64 output, the L6..L2 pyramid of a 64x64 frame and an object
    mask; errors kept off exactly zero (JAX's norm has a NaN gradient
    there, the port's 0)."""
    rs = np.random.RandomState(seed)
    b, h, w = 2, 64, 64
    gt = (rs.randn(b, h, w, 2) * 3).astype(np.float32)
    pred = (gt + rs.randn(b, h, w, 2) + 0.05).astype(np.float32)
    pyr = [rs.randn(b, h >> lvl, w >> lvl, 2).astype(np.float32) for lvl in (6, 5, 4, 3, 2)]
    mask = np.zeros((b, h, w, 1), np.float32)
    mask[:, 20:41, 12:50] = 1.0
    return pred, pyr, gt, mask


@pytest.mark.parametrize("weights", ["none", "final", "all"])
def test_multiscale_epe_matches_jax(weights):
    # the weights pretrain_pwc builds with an object mask and a boundary
    # weight: "final" band only on the output level, "all" on every level
    pred, pyr, gt, mask = _epe_inputs(seed=9)
    kw_j, kw_t = {}, {}
    if weights != "none":
        w = 1.0 + 2.0 * mask
        band = np.asarray(jax_pwc.boundary_band(jnp.asarray(mask)))
        kw_j["weight"] = w + 3.0 * band
        if weights == "final":
            kw_j["weight_aux"] = w
        kw_t = {k: _t(v) for k, v in kw_j.items()}
    want = jax_pwc.multiscale_epe(jnp.asarray(pred), [jnp.asarray(p) for p in pyr],
                                  jnp.asarray(gt), 2, **kw_j)
    got = multiscale_epe(_t(pred), [_t(p) for p in pyr], _t(gt), 2, **kw_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=EPE_RTOL)


# --- pieces of the recover stage ---------------------------------------------
def test_random_box_masks_equal_jax_on_jax_draws():
    b, h, w = 6, 48, 80
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_pretrain.random_box_masks(key, b, h, w))
    r_h, r_w, r_y, r_x = jax.random.split(key, 4)      # pretrain.py:35 there
    draws = {k: _t(jax.random.uniform(r, (b,))) for k, r in
             (("h", r_h), ("w", r_w), ("y", r_y), ("x", r_x))}
    got = random_box_masks(draws, h, w).numpy()
    assert got.shape == (b, h, w, 1)
    np.testing.assert_array_equal(got, want)
    assert 0.0 < want.mean() < 1.0


# --- one recover pretraining step ----------------------------------------------
def test_recover_step_matches_jax():
    sizes = dict(batch_size=2, reader_height=64, reader_width=128, img_height=32, img_width=64)
    jcfg = JaxConfig(**sizes, pwc_search_range=2)
    obj = JaxObjective(jcfg)
    x = (lambda c: jnp.zeros((1, 32, 64, c)))
    params = jax.jit(obj.recover.init)(jax.random.PRNGKey(4), x(3), x(2), x(1))["params"]
    rs = np.random.RandomState(4)
    img1 = rs.uniform(-0.5, 0.5, (2, 64, 128, 3)).astype(np.float32)
    reader_flow = (rs.randn(2, 64, 128, 2) * 6.0).astype(np.float32)
    image, flow = obj.resize_to_working(jnp.asarray(img1), jnp.asarray(reader_flow))
    key = jax.random.PRNGKey(5)
    mask = jax_pretrain.random_box_masks(key, 2, 32, 64)
    clip = jcfg.gradient_clip

    def loss_fn(p):          # train/pretrain.py:108-114
        pred = obj.recover.apply({"params": p}, image, flow * (1.0 - mask), mask)
        total = jax_charbonnier(flow, pred, jnp.ones_like(flow), jcfg.cbn)
        return jnp.sum(total) / (32 * 64 * 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = jax.tree.map(lambda g: jnp.clip(g, -clip, clip), grads)

    r_h, r_w, r_y, r_x = jax.random.split(key, 4)
    draws = {k: torch.from_numpy(np.array(jax.random.uniform(r, (2,)))) for k, r in
             (("h", r_h), ("w", r_w), ("y", r_y), ("x", r_x))}
    port_mask = random_box_masks(draws, 32, 64)
    np.testing.assert_array_equal(port_mask.numpy(), np.asarray(mask))
    trainer = RecoverPretrainer(Config(**sizes, pwc_search_range=2), device="cpu")
    trainer.recover.load_state_dict(convert.recover_state_dict(jax.device_get(params)))
    got_loss, got_grads = trainer.grads(torch.from_numpy(np.array(image)),
                                        torch.from_numpy(np.array(flow)), port_mask)
    assert float(got_loss) == pytest.approx(float(loss), rel=STEP_LOSS_RTOL)
    names = [k for k, _ in trainer.recover.named_parameters()]
    want = convert.recover_state_dict(jax.device_get(grads))
    gaps = {k: float((g - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
            for k, g in zip(names, got_grads)}
    assert set(gaps) == set(want)
    assert max(gaps.values()) <= STEP_GRAD_OF_LARGEST, sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    assert max(float(g.abs().max()) for g in got_grads) <= np.float32(clip)


# --- optimizer and schedule ---------------------------------------------------
@pytest.mark.parametrize("steps", [30, 3000])
def test_warmup_cosine_lr_matches_optax(steps):
    lr = 3e-4
    warmup = min(200, max(1, steps // 10))
    sched = optax.warmup_cosine_decay_schedule(
        init_value=lr / 10, peak_value=lr, warmup_steps=warmup, decay_steps=steps,
        end_value=lr * 0.05)
    for count in (0, 1, warmup - 1, warmup, steps // 2, steps - 1, steps + 5):
        np.testing.assert_allclose(optim.warmup_cosine_lr(count, lr, steps),
                                   float(sched(count)), rtol=1e-6, err_msg=str(count))
    assert optim.warmup_cosine_lr(0, lr, steps) == pytest.approx(lr / 10)
    with pytest.raises(ValueError):
        optim.warmup_cosine_lr(0, lr, 1)             # optax refuses decay_steps <= 0


def test_adam_updates_match_optax():
    # from zero parameters, so that the first update is the parameters
    # after it exactly; then two more updates, parameters compared
    rs = np.random.RandomState(12)
    shapes = ((3, 4), (7,), (2, 3, 3, 5))
    grads = [[(rs.randn(*s) * 10.0**rs.uniform(-4, 0)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    lr, b1, eps = 1e-4, 0.9, 1e-8
    tx = optax.adam(lr, b1=b1, eps=eps)
    jp = [jnp.zeros(s, jnp.float32) for s in shapes]
    state = tx.init(jp)
    tp = [torch.zeros(s) for s in shapes]
    opt = optim.OptaxAdam(tp, lr, b1, eps)
    for step_grads in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step_grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(g) for g in step_grads])
        for p, want in zip(tp, jp):
            np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=ADAM_RTOL)


# --- initialisers -------------------------------------------------------------
def test_pwc_conv_init_is_flax_he_normal():
    # flax he_normal: a normal truncated at +-2 of its scale, rescaled to
    # variance 2 / fan_in; the wide kernel gives ~590k draws
    torch.manual_seed(0)
    conv = PWCConv(256, 256, 3)
    w = conv.weight.detach().double()
    sigma = (2.0 / (256 * 9)) ** 0.5
    assert w.abs().max().item() <= 2.0 * sigma / TRUNCATED_NORMAL_STD
    assert w.abs().max().item() > 1.9 * sigma / TRUNCATED_NORMAL_STD
    assert abs(w.var().item() / sigma**2 - 1.0) < 0.05


@pytest.mark.parametrize("layer", ["conv_transpose", "gen_conv"])
def test_glorot_uniform_layers_match_flax_distribution(layer):
    # flax glorot_uniform on (kh, kw, out, in) (ConvTranspose2D) and
    # (kh, kw, in, out) (GenConv): U(-l, l), l = sqrt(6 / (fan_in + fan_out)),
    # symmetric in the two fans, so the PyTorch layouts give the same l
    torch.manual_seed(1)
    m = ConvTranspose2D(300, 200, 4, 2) if layer == "conv_transpose" else GenConv(300, 200, 3)
    w = m.weight.detach().double()
    k = w.shape[2] * w.shape[3]
    limit = (6.0 / (k * (300 + 200))) ** 0.5
    assert w.abs().max().item() <= limit
    assert abs(w.var().item() / (limit**2 / 3.0) - 1.0) < 0.05
