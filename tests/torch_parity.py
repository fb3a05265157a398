"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py):
seeded numpy frames, flax-layout weights, and the committed checkpoints."""

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAME_CKPT = os.path.join(REPO, "experiments", "game_state_v2lr", "model.best")
PWC_CKPT = os.path.join(REPO, "experiments", "pwc_ckpt_v2", "pwc-final")
PWC_CKPT_SEARCH_RANGE = 2   # every committed PWC checkpoint uses range 2


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
