"""PWCNet and the mask generator of the port against the flax models with
the same weights (carried across by convert.py), on the CPU: random weights
at search range 4, and the committed checkpoints at range 2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import PWC_CKPT_SEARCH_RANGE, committed_checkpoints, moving_square_frames
from unsupervised_detection_tpu.models import GeneratorNet as JaxGenerator
from unsupervised_detection_tpu.models import PWCNet as JaxPWC
from unsupervised_detection_tpu.ops.flow import standardize_flow as jax_standardize
from unsupervised_detection_tpu_torch.convert import from_jax_params, random_jax_params
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet
from unsupervised_detection_tpu_torch.ops.flow import standardize_flow

# float32 through ~40 convolutions (XLA vs oneDNN summation order) and the
# cost volumes: flows agree to 1e-4 of their largest magnitude, masks (in
# [0, 1], behind a softmax) to 1e-4 absolute.
FLOW_RTOL_OF_MAX = 1e-4
MASK_ATOL = 1e-4


def _port_models(search_range):
    return GeneratorNet(), PWCNet(search_range=search_range)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("search_range", [2, 4])
def test_random_flax_layout_matches_flax_init(search_range):
    # random_jax_params, shaped after the port modules, has exactly the flax
    # models' parameter trees; the converter maps every leaf
    gen, pwc = _port_models(search_range)
    gen_p, gen_s, pwc_p = random_jax_params(gen, pwc, seed=0)
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    f = jax.ShapeDtypeStruct((1, 64, 64, 2), jnp.float32)
    key = jax.random.PRNGKey(0)
    want_pwc = jax.eval_shape(JaxPWC(search_range=search_range).init, key, x, x)
    want_gen = jax.eval_shape(JaxGenerator().init, key, x, f)
    assert _shapes(pwc_p) == jax.tree.map(lambda s: s.shape, want_pwc["params"])
    assert _shapes(gen_p) == jax.tree.map(lambda s: s.shape, want_gen["params"])
    assert _shapes(gen_s) == jax.tree.map(lambda s: s.shape, want_gen["batch_stats"])
    gen_sd, pwc_sd = from_jax_params(gen_p, gen_s, pwc_p)
    assert set(gen_sd) == set(gen.state_dict()) and set(pwc_sd) == set(pwc.state_dict())
    gen.load_state_dict(gen_sd)
    pwc.load_state_dict(pwc_sd)


def _pwc_parity(search_range, trees, img1, img2):
    _, _, pwc_p = trees
    want = np.asarray(jax.jit(JaxPWC(search_range=search_range).apply)(
        {"params": pwc_p}, img1, img2))
    pwc = PWCNet(search_range=search_range).eval()
    pwc.load_state_dict(from_jax_params(*trees)[1])
    with torch.no_grad():
        got = pwc(torch.from_numpy(img1), torch.from_numpy(img2)).numpy()
    assert got.shape == want.shape == (*img1.shape[:3], 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FLOW_RTOL_OF_MAX * np.abs(want).max())
    return want


def _mask_parity(trees, image, flow):
    gen_p, gen_s, _ = trees
    want = np.asarray(jax.jit(JaxGenerator().apply)(
        {"params": gen_p, "batch_stats": gen_s}, image, jax_standardize(jnp.asarray(flow))))
    gen = GeneratorNet().eval()
    gen.load_state_dict(from_jax_params(*trees)[0])
    with torch.no_grad():
        got = gen(torch.from_numpy(image),
                  standardize_flow(torch.from_numpy(np.asarray(flow)))).numpy()
    assert got.shape == want.shape == (*image.shape[:3], 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=MASK_ATOL)
    return want


def test_pwc_random_weights_range4_matches_flax():
    trees = random_jax_params(*_port_models(4), seed=1)
    img1, img2, _ = moving_square_frames(2, 64, 64, seed=1)
    flow = _pwc_parity(4, trees, img1, img2)
    assert np.abs(flow).max() > 1e-3      # not a degenerate all-zero flow


def test_generator_mask_matches_flax():
    trees = random_jax_params(*_port_models(4), seed=2)
    img, _, _ = moving_square_frames(2, 48, 96, seed=2)
    flow = np.random.RandomState(2).randn(2, 48, 96, 2).astype(np.float32)
    mask = _mask_parity(trees, img, flow)
    assert mask.std() > 0


@pytest.fixture(scope="module")
def checkpoint_trees():
    return committed_checkpoints()


def test_committed_checkpoints_flow_and_mask_match_flax(checkpoint_trees):
    # PWC (range 2) + generator from the committed checkpoints at 128x192
    img1, img2, _ = moving_square_frames(1, 128, 192, seed=3)
    flow = _pwc_parity(PWC_CKPT_SEARCH_RANGE, checkpoint_trees, img1, img2)
    image = img1[:, ::2, ::2]                       # any working-size image
    flow_w = flow[:, ::2, ::2] / 80.0
    mask = _mask_parity(checkpoint_trees, image, flow_w)
    assert 0.0 <= mask.min() and mask.max() <= 1.0
