"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py):
seeded numpy frames, flax-layout weights, the committed checkpoints, JAX's
augmentation, scene and box draws, the JAX tools' game steps, a tree
comparison, and the thread limit of the port's test files."""

import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAME_CKPT = os.path.join(REPO, "experiments", "game_state_v2lr", "model.best")
PWC_CKPT = os.path.join(REPO, "experiments", "pwc_ckpt_v2", "pwc-final")
PWC_CKPT_SEARCH_RANGE = 2   # every committed PWC checkpoint uses range 2


def torch_threads(n):
    """A module-scoped autouse fixture that holds PyTorch to `n` CPU threads
    while a test file runs; a file takes it as `_threads = torch_threads(n)`.
    The tier-1 run puts six test processes on the host's cores, and
    PyTorch's default of one OpenMP thread per core then oversubscribes them:
    its spin-waiting threads contend, and small CPU convolutions and
    training steps crawl (a dense-path test took 276 s with the default,
    107 s with two threads)."""
    @pytest.fixture(scope="module", autouse=True)
    def _torch_threads():
        saved = torch.get_num_threads()
        torch.set_num_threads(min(saved, n))
        yield
        torch.set_num_threads(saved)
    return _torch_threads


def moving_square_frames(b, h, w, seed=0, shift=(2, 3), square=None):
    """(img1, img2, gt): smooth random texture in [-0.5, 0.5] with a
    textured square that moves by `shift` pixels; gt is the square in
    frame 1 as (B, H, W, 1) {0, 1}. float32 numpy arrays."""
    rs = np.random.RandomState(seed)
    square = square or max(h, w) // 4

    def texture(shape):
        t = rs.rand(*shape).astype(np.float32)
        for axis in (1, 2):          # cheap box blur along H and W
            t = (t + np.roll(t, 1, axis) + np.roll(t, -1, axis)) / 3.0
        return t - 0.5

    bg = texture((b, h + 8, w + 8, 3))
    fg = texture((b, square, square, 3)) * 2.0
    img1 = bg[:, 4:h + 4, 4:w + 4].copy()
    img2 = bg[:, 4 - shift[0]:h + 4 - shift[0], 4 - shift[1]:w + 4 - shift[1]].copy()
    y0, x0 = h // 3, w // 3
    img1[:, y0:y0 + square, x0:x0 + square] = fg
    img2[:, y0 + shift[0]:y0 + shift[0] + square, x0 + shift[1]:x0 + shift[1] + square] = fg
    gt = np.zeros((b, h, w, 1), np.float32)
    gt[:, y0:y0 + square, x0:x0 + square] = 1.0
    return np.clip(img1, -0.5, 0.5), np.clip(img2, -0.5, 0.5), gt


def clamp_flow(rs, b, h, w):
    """(B, H, W, 2) float32 flow whose sources span [-H, 2H) x [-W, 2W):
    taps inside, past every edge (floor and weight clamps), and at integer
    and fractional positions."""
    u = rs.uniform(-1.0, 1.0, size=(b, h, w, 2)).astype(np.float32)
    flow = u * np.array([h, w], np.float32)
    flow[:, ::5] = np.round(flow[:, ::5])          # integer sources
    flow[:, 1, :, 0] = 1.0 + 1e-6                   # just past the top edge
    flow[:, -1, :, 0] = -1.0                        # just past the bottom edge
    return flow


def committed_checkpoints():
    """(gen_params, gen_stats, pwc_params) of the committed game-state and
    PWC checkpoints as nested dicts of numpy arrays."""
    import jax
    import jax.numpy as jnp

    from unsupervised_detection_tpu.models import PWCNet
    from unsupervised_detection_tpu.train import checkpoint as ckpt

    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(PWCNet(search_range=PWC_CKPT_SEARCH_RANGE).init,
                            jax.random.PRNGKey(0), x, x)["params"]
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    pwc_params = ckpt.restore_params_scope(PWC_CKPT, template, "pwc_params")
    # A game-arm save is a full-state dict {"state": TrainState fields, ...};
    # restore it raw, as restore_params_scope's full-state branch does.
    state = ckpt._checkpointer().restore(GAME_CKPT)["state"]
    return jax.device_get((state["gen_params"], state["gen_stats"], pwc_params))


def jax_augment_draws(key, b, h, w, crop):
    """The draws of the JAX package's ops/augment.py::augment_pair from
    `key`, made by JAX's own calls, as the port's apply functions take
    them: {case, p, y0, x0} as (B,) torch tensors."""
    import jax
    import torch

    r_flip, r_crop = jax.random.split(key)
    case = jax.random.randint(r_flip, (b,), 0, 4)
    r_p, r_y, r_x = jax.random.split(r_crop, 3)
    p = crop + jax.random.uniform(r_p, (b,)) * (1.0 - crop)
    y0 = jax.random.uniform(r_y, (b,)) * (h - h * p)
    x0 = jax.random.uniform(r_x, (b,)) * (w - w * p)
    return {k: torch.from_numpy(np.array(v)) for k, v in
            (("case", case), ("p", p), ("y0", y0), ("x0", x0))}


def assert_trees_equal(got, want):
    """Two nested dicts of arrays hold the same paths and bit-equal leaves."""
    import jax

    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), np.asarray(v), err_msg=str(k))


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_game_draws(key, b, h, w, square):
    """`scenes.game_draws` as exp_convergence_v2.make_batch_fn draws them
    from `key` (its split into 8 and each call's shape and bounds)."""
    import jax

    ks = jax.random.split(key, 8)
    u = jax.random.uniform
    return {"bg8": _t(u(ks[0], (b, h // 8, w // 8, 3))),
            "bg2": _t(u(ks[1], (b, h // 2, w // 2, 3))),
            "tex": _t(u(ks[2], (b, h // 4, w // 4, 3))),
            "offset": _t(u(ks[3], (b, 1, 1, 1), minval=-0.2, maxval=0.2)),
            "y0": _t(jax.random.randint(ks[4], (b, 1, 1), 0, h - square)).long(),
            "x0": _t(jax.random.randint(ks[5], (b, 1, 1), 0, w - square)).long(),
            "co_bg": _t(u(ks[6], (b, 2, 3), minval=-1.0, maxval=1.0)),
            "co_obj": _t(u(ks[7], (b, 2, 3), minval=-1.0, maxval=1.0))}


def jax_box_draws(key, b):
    """`train/pretrain.py::sample_box_draws` as the JAX package's
    `random_box_masks` draws them from `key`."""
    import jax

    r_h, r_w, r_y, r_x = jax.random.split(key, 4)
    return {n: _t(jax.random.uniform(r, (b,))) for n, r in
            (("h", r_h), ("w", r_w), ("y", r_y), ("x", r_x))}


def jax_initial_game_weights(obj):
    """(gen_vars, rec_params): the JAX tools' initial weights of `obj`'s
    generator and recover net (PRNGKey 8964 split in 3). The weights do
    not depend on the input's size, so a small one compiles faster."""
    import jax
    import jax.numpy as jnp

    r_gen, r_rec, _ = jax.random.split(jax.random.PRNGKey(8964), 3)
    zeros = jnp.zeros((1, 16, 32, 3)), jnp.zeros((1, 16, 32, 2)), jnp.zeros((1, 16, 32, 1))
    gen_vars, rec_vars = jax.jit(lambda: (obj.generator.init(r_gen, zeros[0], zeros[1]),
                                          obj.recover.init(r_rec, *zeros)))()
    return gen_vars, rec_vars["params"]


def jax_game_steps(obj, cfg, gen_vars, rec_params, batches, box_keys):
    """The JAX game tools' pre_step, rec_step and gen_step
    (exp_convergence_v2.py:192-245, exp_convergence_synth.py:143-185) from
    the JAX package's functions, through one jitted gradient function:
    len(box_keys) warm-start steps on the first batches, a fresh recover
    Adam state, then 1 recover and 3 generator sub-steps per cycle on the
    rest. Returns each step's losses and the final parameters."""
    import jax
    import jax.numpy as jnp

    from unsupervised_detection_tpu.ops.losses import charbonnier_loss
    from unsupervised_detection_tpu.train.learner import _clip_or_noise
    from unsupervised_detection_tpu.train.optim import adam_apply, adam_init
    from unsupervised_detection_tpu.train.pretrain import random_box_masks

    b, h, w = np.shape(batches[0][0])[:3]
    hp = (cfg.learning_rate, cfg.beta1, 0.999, cfg.adam_epsilon)
    stats = gen_vars["batch_stats"]
    # jitted as the tools' steps are (eagerly each leaf's ops compile alone)
    adam_apply, adam_init = jax.jit(adam_apply), jax.jit(adam_init)
    _clip_or_noise = jax.jit(_clip_or_noise, static_argnums=(2, 3, 4))

    @jax.jit
    def grads_of(gen_p, rec_p, image, flow, box_key, weights):
        """The gradients of weights . (generator loss, recover loss,
        inpainting loss) for both nets: with one-hot weights, one loss's
        gradient of its own net, bit for bit (one backward to compile)."""
        mask = random_box_masks(box_key, b, h, w)

        def total(gp, rp):
            out = obj.losses_from_flow(gp, stats, rp, image, flow)
            pred = obj.recover.apply({"params": rp}, image, flow * (1 - mask), mask)
            pre = jnp.sum(charbonnier_loss(flow, pred, jnp.ones_like(flow), cfg.cbn)) / (h * w * b)
            tot = (weights[0] * out.losses["generator"] + weights[1] * out.losses["recover"]
                   + weights[2] * pre)
            return tot, (out.losses, pre)

        return jax.grad(total, argnums=(0, 1), has_aux=True)(gen_p, rec_p)

    gen_p, rec_p = gen_vars["params"], rec_params
    rec_opt = adam_init(rec_p)
    out = {"pre": [], "steps": []}
    one_hot = jnp.eye(3, dtype=jnp.float32)
    for (image, flow), key in zip(batches[:len(box_keys)], box_keys):
        (_, g_pre), (_, pre_loss) = grads_of(gen_p, rec_p, image, flow, key, one_hot[2])
        # per-element clip: _clip_or_noise of the recover net is jnp.clip
        g_pre = _clip_or_noise(key, g_pre, cfg.gradient_clip, cfg.grad_noise_threshold, False)
        rec_p, rec_opt = adam_apply(g_pre, rec_opt, rec_p, rec_opt.count + 1, *hp)
        out["pre"].append(float(pre_loss))
    gen_opt, rec_opt = adam_init(gen_p), adam_init(rec_p)
    rng = jax.random.PRNGKey(1)
    for sub, (image, flow) in enumerate(batches[len(box_keys):]):
        rng, r_noise = jax.random.split(rng)
        t = gen_opt.count + rec_opt.count + 1
        if sub % 4 < cfg.iters_rec:
            (_, g_rec), (losses, _) = grads_of(gen_p, rec_p, image, flow, box_keys[0], one_hot[1])
            g = _clip_or_noise(r_noise, g_rec, cfg.gradient_clip, cfg.grad_noise_threshold, False)
            rec_p, rec_opt = adam_apply(g, rec_opt, rec_p, t, hp[0] * jnp.float32(1.0), *hp[1:])
        else:
            (g_gen, _), (losses, _) = grads_of(gen_p, rec_p, image, flow, box_keys[0], one_hot[0])
            avg = np.mean([np.abs(np.asarray(x)).mean() for x in jax.tree.leaves(g_gen)])
            assert avg >= cfg.grad_noise_threshold   # the noise branch stays off
            g = _clip_or_noise(r_noise, g_gen, cfg.gradient_clip, cfg.grad_noise_threshold, True)
            gen_p, gen_opt = adam_apply(g, gen_opt, gen_p, t, hp[0] * jnp.float32(1.0), *hp[1:])
        out["steps"].append({k: float(v) for k, v in losses.items()})
    out["gen_params"], out["rec_params"] = gen_p, rec_p
    return out


# The game's losses against JAX's: relative, but the reduction rates are
# 1 - a ratio near 1 (the generator's loss the sum of two), so they are held
# relative to the ratios, k - value.
GAME_RATE_TERMS = {"generator": 2, "red_rate": 1, "red_rate_compl": 1}


def game_loss_scale(name, value):
    """What a game loss's difference is relative to."""
    return GAME_RATE_TERMS[name] - value if name in GAME_RATE_TERMS else abs(value)
