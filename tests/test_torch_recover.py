"""The recover net's layers and the recover net against flax, the masked
Charbonnier loss against the JAX one, and convert.py's maps of the recover
net (both directions), on the CPU. `BiasedConv` pads TF SAME (asymmetric
when strided on even inputs); `ResizeConv`'s even k=4 kernel pads 1 before
and 2 after, which odd-sized skips show."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import assert_trees_equal, torch_threads
from unsupervised_detection_tpu.models import RecoverNet as JaxRecoverNet
from unsupervised_detection_tpu.models import layers as jl
from unsupervised_detection_tpu.ops.losses import charbonnier_loss as jax_charbonnier
from unsupervised_detection_tpu_torch import convert
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet
from unsupervised_detection_tpu_torch.models import layers as tl
from unsupervised_detection_tpu_torch.ops.losses import charbonnier_loss


_threads = torch_threads(1)


# float32: conv sums in other orders (XLA vs oneDNN), fan-in <= ~3.5k, on
# O(1) activations
ATOL = 2e-5
# the recover net: 26 float32 convs deep; outputs of O(0.1-1)
NET_ATOL = 1e-5
# bfloat16: both frameworks round activations to 8 mantissa bits after
# every layer, at other places (the port casts after each conv, XLA may
# fuse); relative to the largest output (measured: 2**-8)
BF16_REL = 2.0**-6


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def _perturb(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rs.randn(*np.shape(a)).astype(np.float32),
                        tree)


def _conv_state(params):
    return {"weight": convert.hwio_to_oihw(params["kernel"]),
            "bias": torch.from_numpy(np.asarray(params["bias"]))}


@pytest.mark.parametrize("k,stride,hw,activation", [
    (7, 2, (16, 24), True), (5, 2, (16, 24), True), (3, 2, (16, 24), True),   # 2/3, 1/2, 0/1
    (7, 2, (15, 23), True), (3, 2, (1, 1), True),                              # odd, 1x1
    (3, 1, (9, 14), False), (5, 1, (9, 14), False),                            # heads
])
def test_biased_conv_matches_flax(k, stride, hw, activation):
    layer = jl.BiasedConv(6, k, stride, activation=jl.leaky_relu_02 if activation else None)
    x = _x((2, *hw, 4), 1)
    params = _perturb(layer.init(jax.random.PRNGKey(0), x)["params"], 2)
    want = np.asarray(layer.apply({"params": params}, x))
    port = tl.BiasedConv(4, 6, k, stride, activation=activation)
    port.load_state_dict(_conv_state(params["Conv_0"]))
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("in_hw,size,activation", [
    ((3, 6), (6, 12), True),      # the even x2 of a 192x384 pyramid
    ((2, 4), (3, 8), True),       # odd skip rows
    ((5, 8), (9, 15), False),     # odd both ways (an upflow)
    ((1, 1), (2, 2), True),
])
def test_resize_conv_matches_flax(in_hw, size, activation):
    assert tl.same_pads(9, 4, 1, 1) == (1, 2)
    layer = jl.ResizeConv(5, activation=jl.leaky_relu_02 if activation else None)
    x = _x((2, *in_hw, 3), 3)
    params = _perturb(layer.init(jax.random.PRNGKey(1), x, size)["params"], 4)
    want = np.asarray(layer.apply({"params": params}, x, size))
    assert want.shape == (2, *size, 5)
    port = tl.ResizeConv(3, 5, activation=activation)
    port.load_state_dict(_conv_state(params["conv"]["Conv_0"]))
    np.testing.assert_allclose(_nhwc(port(_nchw(x), size)), want, rtol=0, atol=ATOL)


def _recover_inputs(b, h, w, seed=5):
    rs = np.random.RandomState(seed)
    img = rs.uniform(-0.5, 0.5, (b, h, w, 3)).astype(np.float32)
    flow = rs.randn(b, h, w, 2).astype(np.float32) * 0.3
    mask = rs.uniform(0.0, 1.0, (b, h, w, 1)).astype(np.float32)
    return img, flow * (1.0 - mask), mask


@pytest.fixture(scope="module")
def rec_params():
    return convert.random_recover_params(RecoverNet(), seed=6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(32, 64), (36, 60)], ids=["even", "odd-skips"])
def test_recover_net_matches_flax(rec_params, dtype, hw):
    # 36x60: the encoder's skips are 18x30, 9x15, 5x8, 3x4, 2x2, 1x1
    img, flow_masked, mask = _recover_inputs(2, *hw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(JaxRecoverNet(dtype=jdt).apply({"params": rec_params}, img, flow_masked,
                                                     mask))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    net = RecoverNet(dtype=tdt)
    net.load_state_dict(convert.recover_state_dict(rec_params))
    got = net(*(torch.from_numpy(a) for a in (img, flow_masked, mask)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, *hw, 2)
    scale = np.abs(want).max()
    assert 0.05 < scale < 10.0
    atol = NET_ATOL if dtype == "float32" else BF16_REL * scale
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("cbn", [0.5, 1.0])
def test_charbonnier_loss_matches_jax(cbn):
    rs = np.random.RandomState(7)
    gt, pred = rs.randn(3, 8, 12, 2).astype(np.float32), rs.randn(3, 8, 12, 2).astype(np.float32)
    mask = rs.uniform(0.0, 1.0, (3, 8, 12, 1)).astype(np.float32)
    want = np.asarray(jax_charbonnier(gt, pred, mask, cbn))
    got = charbonnier_loss(*(torch.from_numpy(a) for a in (gt, pred, mask)), cbn)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_convert_maps_are_inverse(rec_params):
    # flax tree -> state dict -> flax tree is the identity for the three
    # nets, and the recover tree has the flax module's exact layout
    net = RecoverNet()
    x = jnp.zeros((1, 32, 64, 3))
    shapes = jax.eval_shape(JaxRecoverNet().init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1, 32, 64, 2)), jnp.zeros((1, 32, 64, 1)))["params"]
    assert jax.tree.map(np.shape, shapes) == jax.tree.map(np.shape, rec_params)
    net.load_state_dict(convert.recover_state_dict(rec_params))
    assert_trees_equal(convert.flax_trees(net, net.state_dict())["params"], rec_params)

    gen, pwc = GeneratorNet(), PWCNet(search_range=2)
    gen_p, gen_s, pwc_p = convert.random_jax_params(gen, pwc, seed=8)
    gen_sd, pwc_sd = convert.from_jax_params(gen_p, gen_s, pwc_p)
    trees = convert.flax_trees(gen, gen_sd)
    assert_trees_equal(trees["params"], gen_p)
    assert_trees_equal(trees["batch_stats"], gen_s)
    assert_trees_equal(convert.flax_trees(pwc, pwc_sd)["params"], pwc_p)
    # a params-shaped tree alone (an Adam moment) maps to the parameters
    assert set(convert.generator_state_dict(gen_p)) == {n for n, _ in gen.named_parameters()}
