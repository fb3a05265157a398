"""Each ported layer against the flax layer with the same weights, on the
CPU: TF SAME padding (asymmetric when strided), dilations 2..16, the
TF-layout transposed conv, the inference-mode BN generator conv and the
subpixel x2 NN-upsample conv."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from torch_parity import torch_threads
from unsupervised_detection_tpu.models import layers as jl
from unsupervised_detection_tpu_torch.convert import hwio_to_oihw, tf_transpose_kernel_to_torch
from unsupervised_detection_tpu_torch.models import layers as tl

_threads = torch_threads(2)

# float32 convolutions with fan-in <= ~1.2k summed in other orders (XLA vs
# oneDNN) on O(1) activations
ATOL = 2e-5


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _perturb(tree, seed):
    """Random values in every leaf (flax inits biases to 0, BN to 1/0)."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rs.randn(*np.shape(a)).astype(np.float32),
                        tree)


@pytest.mark.parametrize("k,stride,rate,hw", [
    (3, 2, 1, (16, 24)), (5, 2, 1, (16, 24)), (7, 2, 1, (16, 24)),   # 0/1, 1/2, 2/3 pads
    (3, 2, 1, (15, 23)), (5, 2, 1, (15, 23)),                         # odd inputs
    (3, 1, 2, (20, 20)), (3, 1, 4, (20, 20)), (3, 1, 8, (20, 20)), (3, 1, 16, (20, 20)),
    (5, 1, 1, (12, 16)),
])
def test_conv2d_same_matches_flax(k, stride, rate, hw):
    assert tl.same_pads(16, 3, 2, 1) == (0, 1)
    assert tl.same_pads(16, 5, 2, 1) == (1, 2)
    assert tl.same_pads(16, 7, 2, 1) == (2, 3)
    conv = nn.Conv(6, (k, k), strides=(stride, stride), kernel_dilation=(rate, rate),
                   padding="SAME", precision=jax.lax.Precision.HIGHEST)
    x = _x((2, *hw, 4))
    params = _perturb(conv.init(jax.random.PRNGKey(0), x)["params"], 1)
    want = np.asarray(conv.apply({"params": params}, x))
    got = tl.conv2d_same(_nchw(x), hwio_to_oihw(params["kernel"]),
                         torch.from_numpy(params["bias"]), stride, rate)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("stride,activation", [(2, True), (1, True), (1, False)])
def test_pwcconv_parts_match_flax(stride, activation):
    # the flax layer takes channel parts; the port takes their concat
    act = jl.leaky_relu_01 if activation else None
    layer = jl.PWCConv(8, 3, stride, activation=act)
    parts = [_x((1, 12, 16, 5), 2), _x((1, 12, 16, 3), 3), _x((1, 12, 16, 2), 4)]
    params = _perturb(layer.init(jax.random.PRNGKey(1), parts)["params"], 5)
    want = np.asarray(layer.apply({"params": params}, parts))
    port = tl.PWCConv(10, 8, 3, stride, activation=activation)
    port.load_state_dict({"weight": hwio_to_oihw(params["Conv_0"]["kernel"]),
                          "bias": torch.from_numpy(params["Conv_0"]["bias"])})
    got = port(_nchw(np.concatenate(parts, axis=3)))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw", [(6, 10), (12, 20)])
def test_conv_transpose_matches_flax(hw):
    layer = jl.ConvTranspose2D(2, 4, 2)
    parts = [_x((2, *hw, 7), 6), _x((2, *hw, 2), 7)]
    params = _perturb(layer.init(jax.random.PRNGKey(2), parts)["params"], 8)
    want = np.asarray(layer.apply({"params": params}, parts))
    assert want.shape == (2, 2 * hw[0], 2 * hw[1], 2)
    port = tl.ConvTranspose2D(9, 2, 4, 2)
    port.load_state_dict({"weight": tf_transpose_kernel_to_torch(params["kernel"]),
                          "bias": torch.from_numpy(params["bias"])})
    got = port(_nchw(np.concatenate(parts, axis=3)))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=ATOL)


def _gen_state(params, stats):
    return {"weight": hwio_to_oihw(params["conv"]["kernel"]),
            "bias": torch.from_numpy(np.asarray(params["conv"]["bias"])),
            "bn_gamma": torch.from_numpy(np.asarray(params["bn_gamma"])),
            "bn_beta": torch.from_numpy(np.asarray(params["bn_beta"])),
            "bn_moving_mean": torch.from_numpy(np.asarray(stats["bn_moving_mean"])),
            "bn_moving_variance": torch.from_numpy(np.abs(np.asarray(stats["bn_moving_variance"])))}


@pytest.mark.parametrize("k,stride,rate,activation", [
    (5, 1, 1, True), (3, 2, 1, True), (3, 1, 2, True), (3, 1, 16, True), (3, 1, 1, False),
])
def test_genconv_matches_flax(k, stride, rate, activation):
    layer = jl.GenConv(6, k, stride, rate, activation=nn.elu if activation else None)
    x = _x((2, 24, 32, 5), 9)
    variables = layer.init(jax.random.PRNGKey(3), x)
    params = _perturb(variables["params"], 10)
    stats = _perturb(variables["batch_stats"], 11)
    stats = jax.tree.map(np.abs, stats)   # a variance stays positive
    want = np.asarray(layer.apply({"params": params, "batch_stats": stats}, x))
    port = tl.GenConv(5, 6, k, stride, rate, activation=activation)
    port.load_state_dict(_gen_state(params, stats))
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gendeconv_matches_flax(dtype):
    # x2 NN upsample + 3x3 conv via the subpixel decomposition; bfloat16
    # rounds activations and the collapsed kernel taps at other places in
    # the two frameworks -> a few bfloat16 ulps of the O(1) outputs
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    layer = jl.GenDeconv(4, dtype=jdt)
    x = _x((2, 6, 10, 8), 12)
    variables = layer.init(jax.random.PRNGKey(4), x)
    params = _perturb(variables["params"], 13)
    stats = jax.tree.map(np.abs, _perturb(variables["batch_stats"], 14))
    want = np.asarray(layer.apply({"params": params, "batch_stats": stats}, x)
                      .astype(jnp.float32))
    assert want.shape == (2, 12, 20, 4)
    port = tl.GenDeconv(8, 4)
    port.load_state_dict(_gen_state(params["conv"], stats["conv"]))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = _nhwc(port(_nchw(x).to(tdt)).float())
    atol = ATOL if dtype == "float32" else 8 * 2.0**-8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_subpixel_conv_equals_upsample_then_conv():
    # the decomposition is the x2 pixel replication followed by a SAME 3x3 conv
    x = torch.from_numpy(_x((1, 3, 5, 7), 15)).permute(0, 3, 1, 2)
    w = torch.from_numpy(_x((4, 7, 3, 3), 16))
    b = torch.from_numpy(_x((4,), 17))
    up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    want = torch.nn.functional.conv2d(up, w, b, padding=1)
    torch.testing.assert_close(tl.nn2_subpixel_conv3(x, w, b), want, rtol=0, atol=ATOL)
