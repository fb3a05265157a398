"""The port's flagship path end to end -- `Evaluator.infer_metrics`: central
crop, PWC flow (range 4), working resize, generator mask, IoU/MAE -- against
the JAX package's evaluator on the same frames and weights, on the CPU, at
reader 128x192 / working 64x96, in float32 and bfloat16; and with the flow
net at half resolution (flow_resolution_divisor=2, reader 128x256)."""

import numpy as np
import pytest
import torch

from torch_parity import moving_square_frames
from unsupervised_detection_tpu.config import Config as JaxConfig
from unsupervised_detection_tpu.eval.evaluator import Evaluator as JaxEvaluator
from unsupervised_detection_tpu_torch import Config
from unsupervised_detection_tpu_torch.convert import from_jax_params, random_jax_params
from unsupervised_detection_tpu_torch.eval import Evaluator
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet

SIZES = dict(batch_size=2, reader_height=128, reader_width=192, img_height=64, img_width=96)
# PWC needs the flow resolution divisible by 64: 128x256 / 2 = 64x128
HALF_FLOW = dict(SIZES, reader_width=256, img_width=128, flow_resolution_divisor=2)
# float32: conv sums in other orders move the soft mask by ~1e-5, which can
# flip a pixel lying that close to the 0.1 threshold: IoU/MAE within 1e-3.
# bfloat16: both sides round activations to 8 mantissa bits at other places
# through ~50 layers; the masks differ by ~1e-2 and a few percent of the
# pixels near the threshold may flip: IoU/MAE within 0.05.
TOL = {"float32": 1e-3, "bfloat16": 0.05}


@pytest.fixture(scope="module")
def weights():
    """Random weights in the flax layout, with the generator's head scaled
    up so the mask spans [0, 1] and the metrics see both classes."""
    gen_p, gen_s, pwc_p = random_jax_params(GeneratorNet(), PWCNet(search_range=4), seed=4)
    gen_p["conv17"]["conv"]["kernel"] = gen_p["conv17"]["conv"]["kernel"] * 100.0
    return gen_p, gen_s, pwc_p


def _frames(sizes):
    return moving_square_frames(sizes["batch_size"], sizes["reader_height"],
                                sizes["reader_width"], seed=5, shift=(3, 4))


@pytest.fixture(scope="module")
def frames():
    return _frames(SIZES)


@pytest.mark.parametrize("dtype,sizes", [
    ("float32", SIZES), ("bfloat16", SIZES),
    # both working-resize branches with the divisor: two-stage (float32)
    # and fused (bfloat16)
    ("float32", HALF_FLOW), ("bfloat16", HALF_FLOW),
], ids=["float32", "bfloat16", "float32-half-flow", "bfloat16-half-flow"])
def test_infer_metrics_matches_jax_evaluator(dtype, sizes, weights):
    img1, img2, gt = _frames(sizes)
    jax_ev = JaxEvaluator(JaxConfig(compute_dtype=dtype, **sizes))
    want = jax_ev.infer_metrics(*weights, img1, img2, gt)
    want = {k: np.asarray(v) for k, v in want.items()}

    ev = Evaluator(Config(compute_dtype=dtype, **sizes), device="cpu")
    ev.load_state_dicts(*from_jax_params(*weights))
    got = ev.infer_metrics(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(gt))
    for k in ("iou", "mae"):
        assert got[k].shape == (sizes["batch_size"],)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=TOL[dtype], err_msg=k)
    # the masks are not degenerate: both metrics strictly inside (0, 1)
    assert (0 < want["mae"]).all() and (want["mae"] < 1).all()


def test_float32_entry_point_restores_tf32_settings(weights, frames):
    # the float32 path turns TF32 off only inside each call
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    ev = Evaluator(Config(**SIZES), device="cpu")
    ev.load_state_dicts(*from_jax_params(*weights))
    img1, img2, gt = (torch.from_numpy(a) for a in frames)
    ev.infer_metrics(img1, img2, gt)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved
