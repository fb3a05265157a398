"""The training half of the objective and its parts against the JAX
package, on the CPU: `losses_from_flow` (all 8 losses) and its gradients
w.r.t. the generator and the recover parameters against `jax.grad`; the
augmentation's crop matrices and apply functions on draws made by JAX's own
calls, and the sampler's statistics; TF1 Adam with the shared step
interleaved against `optim.adam_apply`; `_clip_or_noise` against JAX's.
Working resolution 32x64, batch 4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import jax_augment_draws, torch_threads
from unsupervised_detection_tpu.config import Config as JaxConfig
from unsupervised_detection_tpu.ops import augment as jaug
from unsupervised_detection_tpu.ops.resize import crop_resize_matrices as jax_crop_matrices
from unsupervised_detection_tpu.train.learner import _clip_or_noise as jax_clip_or_noise
from unsupervised_detection_tpu.train.objective import AdversarialObjective as JaxObjective
from unsupervised_detection_tpu.train.optim import adam_apply as jax_adam_apply
from unsupervised_detection_tpu.train.optim import adam_init as jax_adam_init
from unsupervised_detection_tpu_torch import Config, convert
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet
from unsupervised_detection_tpu_torch.ops import augment
from unsupervised_detection_tpu_torch.ops.resize import crop_resize_matrices
from unsupervised_detection_tpu_torch.train import optim
from unsupervised_detection_tpu_torch.train.learner import _clip_or_noise
from unsupervised_detection_tpu_torch.train.objective import AdversarialObjective


_threads = torch_threads(1)


B, H, W = 4, 32, 64
LOSS_KEYS = ("generator", "recover", "red_rate", "red_rate_compl", "reconstruction_loss",
             "reconstruction_compl_loss", "denominator_red_rate",
             "denominator_red_rate_compl")
# float32 losses: sums over B*H*W of terms that differ by conv-order noise
LOSS_RTOL = 1e-5
# float32 gradients, per tensor, relative to the tensor's largest element
GRAD_REL = 1e-4
# float32 matrices built with the same formula, op for op
MATRIX_ATOL = 1e-6


@pytest.fixture(scope="module")
def trees():
    gen_p, gen_s, pwc_p = convert.random_jax_params(GeneratorNet(), PWCNet(search_range=2),
                                                    seed=11)
    return gen_p, gen_s, convert.random_recover_params(RecoverNet(), seed=12), pwc_p


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(13)
    image = rs.uniform(-0.5, 0.5, (B, H, W, 3)).astype(np.float32)
    base = rs.randn(B, H // 8, W // 8, 2).astype(np.float32) * 4.0
    flow = np.asarray(jax.image.resize(jnp.asarray(base), (B, H, W, 2), "linear")) / 80.0
    return image, flow


def test_losses_and_gradients_match_jax(trees, inputs):
    gen_p, gen_s, rec_p, pwc_p = trees
    image, flow = inputs
    jobj = JaxObjective(JaxConfig(img_height=H, img_width=W, batch_size=B))

    def jax_loss(key, wrt):
        def fn(p):
            gp, rp = (p, rec_p) if wrt == "gen" else (gen_p, p)
            out = jobj.losses_from_flow(gp, gen_s, rp, image, flow)
            return out.losses[key], out.losses
        return jax.jit(jax.grad(fn, has_aux=True))

    j_gen_grads, j_losses = jax_loss("generator", "gen")(gen_p)
    j_rec_grads, _ = jax_loss("recover", "rec")(rec_p)

    obj = AdversarialObjective(Config(img_height=H, img_width=W, batch_size=B), device="cpu")
    gen_sd, _ = convert.from_jax_params(gen_p, gen_s, pwc_p)
    obj.generator.load_state_dict(gen_sd)
    obj.recover.load_state_dict(convert.recover_state_dict(rec_p))
    out = obj.losses_from_flow(torch.from_numpy(image), torch.from_numpy(flow))
    assert set(out.losses) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(out.losses[k].detach()), float(j_losses[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(out.pred_flow.detach().numpy(), np.asarray(
        jobj.losses_from_flow(gen_p, gen_s, rec_p, image, flow).pred_flow), rtol=0, atol=1e-5)

    for net, key, want, to_sd in ((obj.generator, "generator", j_gen_grads,
                                   convert.generator_state_dict),
                                  (obj.recover, "recover", j_rec_grads,
                                   convert.recover_state_dict)):
        params = dict(net.named_parameters())
        out = obj.losses_from_flow(torch.from_numpy(image), torch.from_numpy(flow))
        grads = dict(zip(params, torch.autograd.grad(out.losses[key], list(params.values()))))
        want_sd = to_sd(jax.device_get(want))
        assert set(grads) == set(want_sd)
        for name, g in grads.items():
            w = want_sd[name].numpy()
            assert np.abs(w).max() > 0, name
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_REL * np.abs(w).max(),
                                       err_msg=f"{key} grad {name}")


def test_crop_resize_matrices_match_jax():
    d = jax_augment_draws(jax.random.PRNGKey(3), 6, 24, 40, 0.7)
    p, y0 = d["p"], d["y0"]
    want = jax.vmap(lambda s, o: jax_crop_matrices(24, 24, s, o, clamp_lo=o,
                                                   clamp_hi=o + 24 * s - 1.0))(
        jnp.asarray(p.numpy()), jnp.asarray(y0.numpy()))
    got = crop_resize_matrices(24, 24, p, y0, clamp_lo=y0, clamp_hi=y0 + 24 * p - 1.0)
    assert got.shape == (6, 24, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MATRIX_ATOL)
    # unclamped: the whole axis
    want = jax.vmap(lambda s, o: jax_crop_matrices(20, 12, s, o))(jnp.full(6, 1.5),
                                                                  jnp.zeros(6))
    got = crop_resize_matrices(20, 12, torch.full((6,), 1.5), torch.zeros(6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("crop", [0.9, 0.5])
def test_augment_apply_matches_jax_onjax_augment_draws(crop):
    rs = np.random.RandomState(4)
    img1 = rs.uniform(-0.5, 0.5, (8, 24, 40, 3)).astype(np.float32)
    img2 = rs.uniform(-0.5, 0.5, (8, 24, 40, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    d = jax_augment_draws(key, 8, 24, 40, crop)
    r_flip, r_crop = jax.random.split(key)
    want_flip = jaug.random_flip_pair(r_flip, img1, img2)
    got_flip = augment.random_flip_pair(d["case"], torch.from_numpy(img1),
                                        torch.from_numpy(img2))
    for g, w in zip(got_flip, want_flip):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jaug.augment_pair(key, img1, img2, crop)
    got = augment.augment_pair(d, torch.from_numpy(img1), torch.from_numpy(img2))
    for g, w in zip(got, want):
        # the same matrices applied as float32 matmuls in other orders
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_sampler_statistics():
    gen = torch.Generator().manual_seed(0)
    n = 8000
    d = augment.sample_augment(gen, n, 24, 40, 0.9)
    counts = np.bincount(d["case"].numpy(), minlength=4) / n
    assert np.all(np.abs(counts - 0.25) < 0.02), counts
    p = d["p"].numpy()
    assert p.min() >= 0.9 and p.max() <= 1.0 and p.max() - p.min() > 0.09
    assert np.all(d["y0"].numpy() >= 0) and np.all(d["y0"].numpy() <= 24 - 24 * p + 1e-5)
    assert np.all(d["x0"].numpy() >= 0) and np.all(d["x0"].numpy() <= 40 - 40 * p + 1e-5)
    # the same seed gives the same draws
    again = augment.sample_augment(torch.Generator().manual_seed(0), n, 24, 40, 0.9)
    assert all(torch.equal(d[k], again[k]) for k in d)


LR, B1, B2, EPS = 1e-4, 0.9, 0.999, 1e-8


def test_adam_shared_step_interleaved_matches_jax():
    # 'a' plays the generator, 'b' the recover: gen gen gen rec, twice
    rs = np.random.RandomState(3)
    a0, b0 = rs.randn(5, 7).astype(np.float32), rs.randn(11).astype(np.float32)
    schedule = ["a", "a", "a", "b"] * 2
    grads = [rs.randn(*(a0 if w == "a" else b0).shape).astype(np.float32) * 0.3
             for w in schedule]

    ja, jb = jnp.asarray(a0), jnp.asarray(b0)
    joa, job = jax_adam_init(ja), jax_adam_init(jb)
    pa, pb = {"w": torch.from_numpy(a0.copy())}, {"w": torch.from_numpy(b0.copy())}
    oa, ob = optim.adam_init(pa), optim.adam_init(pb)
    for which, g in zip(schedule, grads):
        t = oa.count + ob.count + 1
        assert t == int(joa.count + job.count + 1)
        if which == "a":
            ja, joa = jax_adam_apply(jnp.asarray(g), joa, ja, t, LR, B1, B2, EPS)
            oa = optim.adam_apply({"w": torch.from_numpy(g)}, oa, pa, t, LR, B1, B2, EPS)
        else:
            jb, job = jax_adam_apply(jnp.asarray(g), job, jb, t, LR, B1, B2, EPS)
            ob = optim.adam_apply({"w": torch.from_numpy(g)}, ob, pb, t, LR, B1, B2, EPS)
        # lr_t from float32 powers, as optim.py:59
        t32 = jnp.float32(t)
        want_lr = np.float32(LR * jnp.sqrt(1.0 - B2**t32) / (1.0 - B1**t32))
        np.testing.assert_allclose(optim.lr_at(t, LR, B1, B2), want_lr, rtol=1e-7)
    assert (oa.count, ob.count) == (int(joa.count), int(job.count)) == (6, 2)
    # float32 order-of-operations noise only (~3e-7 on O(1) parameters)
    np.testing.assert_allclose(pa["w"].numpy(), np.asarray(ja), rtol=0, atol=5e-7)
    np.testing.assert_allclose(pb["w"].numpy(), np.asarray(jb), rtol=0, atol=5e-7)
    for got, want in ((oa, joa), (ob, job)):
        np.testing.assert_allclose(got.m["w"].numpy(), np.asarray(want.m), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got.v["w"].numpy(), np.asarray(want.v), rtol=1e-6, atol=1e-12)


def test_leaf_counts_equal(trees):
    # _clip_or_noise averages per tensor: the port's tensors are the flax leaves
    gen_p, _, rec_p, _ = trees
    assert len(list(GeneratorNet().parameters())) == len(jax.tree.leaves(gen_p)) == 68
    assert len(list(RecoverNet().parameters())) == len(jax.tree.leaves(rec_p)) == 64


@pytest.mark.parametrize("avg_over_threshold", [0.5, 0.99, 1.01, 3.0, 1e5])
def test_clip_or_noise_matches_jax(avg_over_threshold):
    clip, thr = 0.2, 1e-5
    rs = np.random.RandomState(6)
    shapes = [(3, 3, 5, 8), (8,), (8,), (8,), (4, 4, 2, 3), (3,)]
    raw = [rs.randn(*s).astype(np.float32) for s in shapes]
    # scale every tensor so that the mean over tensors of mean|g| is exact
    avg = np.mean([np.abs(g).mean() for g in raw])
    grads = [g * np.float32(avg_over_threshold * thr / avg) for g in raw]
    jax_grads = {f"leaf{i}": jnp.asarray(g) for i, g in enumerate(grads)}
    for can_change in (False, True):
        want = jax.tree.leaves(jax_clip_or_noise(jax.random.PRNGKey(0), jax_grads, clip, thr,
                                                 can_change))
        want_clip = [np.clip(g, -clip, clip) for g in grads]
        jax_noised = not all(np.array_equal(np.asarray(w), c) for w, c in zip(want, want_clip))
        got = _clip_or_noise(torch.Generator().manual_seed(1),
                             [torch.from_numpy(g) for g in grads], clip, thr, can_change)
        port_noised = not all(np.array_equal(g.numpy(), c) for g, c in zip(got, want_clip))
        assert port_noised == jax_noised == (can_change and avg_over_threshold < 1.0)
        for g, s in zip(got, shapes):
            assert tuple(g.shape) == s and g.dtype == torch.float32
            if port_noised:
                assert float(g.min()) >= 0.0 and float(g.max()) <= clip
