"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The backward kernels are held to their plain backwards: float32 within
1e-5 of each gradient's largest element (sums in other orders; the warp's
image gradient adds with atomics in no fixed order), bfloat16 within 2^-7
of it (both sum in float32 and round once; an atomic sum may round to the
neighbouring bfloat16). The cost volume's backward is also held at exactly
zero costs (slope 1) and to the same bits in two calls. The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_card.py
"""

import numpy as np
import pytest
import torch

from torch_parity import clamp_flow
from unsupervised_detection_tpu_torch.ops.cost_volume import (
    cost_volume, cost_volume_backward, cost_volume_backward_plain, cost_volume_forward,
    cost_volume_plain, dy_rows)
from unsupervised_detection_tpu_torch.ops.dynamic_copy import dynamic_copy, dynamic_copy_plain
from unsupervised_detection_tpu_torch.ops.warp import (
    dense_image_warp, warp_backward, warp_backward_plain, warp_plain)

# PWC level-6 and level-2 shapes at batch 2 (reader 384x640), then ragged
# ones: the 1x1 and 2x3 levels of small pyramids, batch 1, H and W off the
# kernel's row and pixel tiles, C off its 64-byte chunk, odd C (4- and
# 2-byte staging copies), C=98 (4-byte copies in bfloat16)
SHAPES = ((2, 6, 10, 196), (2, 96, 160, 32), (1, 1, 1, 196), (1, 2, 3, 96),
          (1, 13, 70, 64), (3, 7, 11, 33), (2, 5, 9, 98))
# PWC level-5 and level-2 shapes, then ragged ones: C=1 (masks), C % 8 != 0
# (the scalar path), the smallest image the warp takes, H and W odd
WARP_SHAPES = ((2, 12, 20, 128), (2, 96, 160, 32), (1, 2, 2, 1), (1, 12, 20, 1),
               (3, 7, 11, 33), (2, 5, 9, 12), (1, 13, 70, 64))
# The cost volume's backward tiles rows (TY), pixels (TX) and channel
# chunks of up to 8 quads: besides SHAPES, H and W off both tiles, C one
# quad past a chunk (36) and one channel past a quad (33), C under a quad
# (3), the level-4 and level-5 shapes at batch 1
BACKWARD_SHAPES = SHAPES + ((1, 24, 40, 96), (1, 12, 20, 128), (2, 11, 37, 36),
                            (1, 9, 23, 3), (1, 17, 45, 33))
# The warp's backward: besides WARP_SHAPES, C % 4 != 0 with C > 4 (6) and a
# quad count that is not a power of two (C=24, 6 quads)
WARP_BACKWARD_SHAPES = WARP_SHAPES + ((2, 7, 9, 6), (1, 12, 20, 24))
# The post-processing path's shapes: PWC's levels (L6..L2) in the 4-crop
# ensemble at 4B = 32 (reader 384x640), and in the PWC propagation
# backend at batch 1 (frames 192x384); the warp also at C=1 on a whole
# 192x384 frame (its scalar path at the working resolution)
ENSEMBLE_LEVELS = tuple((32, h, w, c) for h, w, c in (
    (6, 10, 196), (12, 20, 128), (24, 40, 96), (48, 80, 64), (96, 160, 32)))
PAIR_LEVELS = tuple((1, h, w, c) for h, w, c in (
    (3, 6, 196), (6, 12, 128), (12, 24, 96), (24, 48, 64), (48, 96, 32)))
POSTPROC_WARP_SHAPES = ENSEMBLE_LEVELS[1:] + PAIR_LEVELS[1:] + ((1, 192, 384, 1),)


@pytest.fixture
def cuda_device():
    """The card; the CUDA kernels have no CPU mode, so skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels run only on the card")
    return torch.device("cuda")


def _check_cost_volume(device, shape):
    # float32: sums in other orders, 1e-5 on costs ~0.1; bfloat16: one ulp of
    # the largest cost (both sum in float32 and round once)
    rs = np.random.RandomState(0)
    a, b = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device)
            for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        for r in (2, 4):
            x, y = a.to(dtype), b.to(dtype)
            want = cost_volume_plain(x, y, r)
            before = cost_volume.launches
            got = cost_volume(x, y, r)
            torch.cuda.synchronize()
            assert cost_volume.launches == before + 1
            assert got.dtype == dtype and got.shape == want.shape
            limit = 1e-5 if dtype == torch.float32 else 2.0**-7 * want.float().abs().max().item()
            assert (got.float() - want.float()).abs().max().item() <= limit


def _check_warp(device, shape):
    # the kernel repeats the plain version's arithmetic op for op
    rs = np.random.RandomState(1)
    image = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device)
    flow = torch.from_numpy(clamp_flow(rs, *shape[:3])).to(device)
    for dtype in (torch.float32, torch.bfloat16):
        im, fl = image.to(dtype), flow.to(dtype)
        before = dense_image_warp.launches
        got = dense_image_warp(im, fl)
        torch.cuda.synchronize()
        assert dense_image_warp.launches == before + 1
        assert torch.equal(got, warp_plain(im, fl))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cost_volume_kernel_matches_plain(cuda_device, shape):
    _check_cost_volume(cuda_device, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + ((16, 96, 160, 32), (16, 6, 10, 196)))
def test_cost_volume_dy_ranges_are_the_whole_volumes_rows(cuda_device, shape):
    """A launch over the dy rows [d0, d1) of each part of 2, 3, 4, 2r+1 and
    2r+2 (an empty one) writes exactly the whole volume's channels of those
    rows, bit for bit, and zero elsewhere; the parts sum to the whole
    volume; one launch per nonempty part. The plain version over the same
    range is the plain whole volume's rows."""
    rs = np.random.RandomState(1)
    a, b = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda_device)
            for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        for r in (2, 4):
            x, y = a.to(dtype), b.to(dtype)
            d = 2 * r + 1
            whole, plain = cost_volume_forward(x, y, r), cost_volume_plain(x, y, r)
            for parts in (2, 3, 4, d, d + 1):
                total = torch.zeros_like(whole, dtype=torch.float32)
                for i in range(parts):
                    d0, d1 = dy_rows(r, parts, i)
                    before = cost_volume.launches
                    got = cost_volume_forward(x, y, r, dy_range=(d0, d1))
                    torch.cuda.synchronize()
                    assert cost_volume.launches == before + (d1 > d0)
                    rows = slice(d0 * d, d1 * d)
                    assert torch.equal(got[..., rows], whole[..., rows]), (dtype, r, parts, i)
                    assert torch.equal(cost_volume_plain(x, y, r, (d0, d1))[..., rows],
                                       plain[..., rows])
                    got[..., rows] = 0
                    assert not got.any()
                    total += cost_volume_forward(x, y, r, dy_range=(d0, d1)).float()
                assert torch.equal(total.to(dtype), whole)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_kernel_bit_equal_to_plain(cuda_device, shape):
    _check_warp(cuda_device, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ENSEMBLE_LEVELS + PAIR_LEVELS)
def test_cost_volume_kernel_at_postproc_shapes(cuda_device, shape):
    _check_cost_volume(cuda_device, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", POSTPROC_WARP_SHAPES)
def test_warp_kernel_at_postproc_shapes(cuda_device, shape):
    _check_warp(cuda_device, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", (0, 1))
def test_dynamic_copy_kernel_bit_equal_to_slice(cuda_device, axis):
    # the repro's buffers and offset 2; the offset stays on the card
    shape = (1024, 256) if axis == 0 else (128, 1024)
    src = torch.from_numpy(np.random.RandomState(2).rand(*shape).astype(np.float32))
    offs = torch.tensor([2], dtype=torch.int32)
    want = dynamic_copy_plain(offs, src, axis)
    before = dynamic_copy.launches
    got = dynamic_copy(offs.to(cuda_device), src.to(cuda_device), axis)
    torch.cuda.synchronize()
    assert dynamic_copy.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _of_largest(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)
            ).item()


BACKWARD_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
def test_cost_volume_backward_kernel_matches_plain(cuda_device, shape):
    rs = np.random.RandomState(3)
    a, b = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda_device)
            for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        for r in (2, 4):
            x, y = a.to(dtype), b.to(dtype)
            out = cost_volume_plain(x, y, r)
            g = torch.randn(out.shape, device=cuda_device).to(dtype)
            want = cost_volume_backward_plain(x, y, out, g, r)
            before = cost_volume_backward.launches
            got = cost_volume_backward(x, y, out, g, r)
            torch.cuda.synchronize()
            assert cost_volume_backward.launches == before + 1
            for gt, wt in zip(got, want):
                assert gt.dtype == dtype and gt.shape == wt.shape
                assert _of_largest(gt, wt) <= BACKWARD_LIMIT[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_backward_slope_one_at_zero_cost(cuda_device, dtype):
    # c1 lives in the first half of the channels and warp in the second, so
    # every cost is exactly 0: JAX's leaky_relu passes g with slope 1 there
    # (a slope of 0.1 would give a tenth of the gradient)
    rs = np.random.RandomState(6)
    shape = (2, 12, 20, 64)
    a, b = rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)
    a[..., 32:] = 0.0
    b[..., :32] = 0.0
    x, y = (torch.from_numpy(v).to(cuda_device).to(dtype) for v in (a, b))
    out = cost_volume_plain(x, y, 4)
    assert not bool(out.any())
    g = torch.from_numpy(rs.randn(*out.shape).astype(np.float32)).to(cuda_device).to(dtype)
    got = cost_volume_backward(x, y, out, g, 4)
    want = cost_volume_backward_plain(x, y, torch.ones_like(out), g, 4)
    for gt, wt in zip(got, want):
        assert _of_largest(gt, wt) <= BACKWARD_LIMIT[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 96, 160, 32), (16, 6, 10, 196), (3, 7, 11, 33)])
def test_cost_volume_backward_same_bits_every_call(cuda_device, shape):
    # sums in a fixed order, no atomics
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        x, y = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
                for _ in range(2))
        out = cost_volume(x, y, 4)
        g = torch.randn(out.shape, generator=gen, device=cuda_device).to(dtype)
        first = cost_volume_backward(x, y, out, g, 4)
        second = cost_volume_backward(x, y, out, g, 4)
        assert all(torch.equal(u, v) for u, v in zip(first, second))


def _far_flow(rs, b, h, w):
    """Flow of 40 to 60 pixels either way on each axis: taps land far from
    their pixel (clamped where they leave the image)."""
    mag = rs.uniform(40.0, 60.0, size=(b, h, w, 2)) * rs.choice([-1.0, 1.0], size=(b, h, w, 2))
    return mag.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("flow_kind", ["clamp", "zero", "far"])
@pytest.mark.parametrize("shape", WARP_BACKWARD_SHAPES)
def test_warp_backward_kernel_matches_plain(cuda_device, shape, flow_kind):
    rs = np.random.RandomState(4)
    image = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda_device)
    if flow_kind == "zero":
        flow = np.zeros((*shape[:3], 2), np.float32)
    else:
        flow = (clamp_flow if flow_kind == "clamp" else _far_flow)(rs, *shape[:3])
    flow = torch.from_numpy(flow).to(cuda_device)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        im, fl, gg = image.to(dtype), flow.to(dtype), g.to(dtype)
        want = warp_backward_plain(im, fl, gg)
        before = warp_backward.launches
        got = warp_backward(im, fl, gg)
        torch.cuda.synchronize()
        assert warp_backward.launches == before + 1
        for gt, wt in zip(got, want):
            assert gt.dtype == dtype and gt.shape == wt.shape
            assert _of_largest(gt, wt) <= BACKWARD_LIMIT[dtype]


@pytest.mark.cuda
def test_autograd_on_the_card_goes_through_the_kernels(cuda_device):
    rs = np.random.RandomState(5)
    image = torch.from_numpy(rs.randn(2, 12, 20, 32).astype(np.float32)).to(cuda_device)
    flow = torch.from_numpy(clamp_flow(rs, 2, 12, 20)).to(cuda_device)
    image.requires_grad_()
    flow.requires_grad_()
    counts = (cost_volume_backward.launches, warp_backward.launches)
    out = cost_volume(dense_image_warp(image, flow), image, 2)
    assert out.grad_fn is not None
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (cost_volume_backward.launches, warp_backward.launches) == (counts[0] + 1,
                                                                       counts[1] + 1)
    assert bool(torch.isfinite(image.grad).all()) and bool(torch.isfinite(flow.grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,w", [(6, 48, 80), (24, 192, 384)])
def test_scan_propagate_on_the_card_matches_plain(cuda_device, t, h, w):
    """postproc.propagate.scan_propagate on CUDA tensors (the warp kernel
    at B = 1, C = 1, 2(T-1) launches) against the same call on CPU tensors
    (warp_plain): the kernel repeats warp_plain's arithmetic and max is
    exact, so within 1e-6 (bit-equal expected)."""
    from unsupervised_detection_tpu_torch.postproc.propagate import scan_propagate

    rs = np.random.RandomState(3)
    masks = torch.from_numpy(rs.rand(t, h, w).astype(np.float32))
    flows = torch.from_numpy(rs.uniform(-6.0, 6.0, (t - 1, h, w, 2)).astype(np.float32))
    want = scan_propagate(masks, flows)
    before = dense_image_warp.launches
    got = scan_propagate(masks.to(cuda_device), flows.to(cuda_device))
    torch.cuda.synchronize()
    assert dense_image_warp.launches == before + 2 * (t - 1)
    assert (got.cpu() - want).abs().max().item() <= 1e-6
