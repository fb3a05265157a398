"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_card.py
"""

import numpy as np
import pytest
import torch

from torch_parity import clamp_flow
from unsupervised_detection_tpu_torch.ops.cost_volume import cost_volume, cost_volume_plain
from unsupervised_detection_tpu_torch.ops.warp import dense_image_warp, warp_plain

# PWC level-6 and level-2 shapes at batch 2 (reader 384x640)
SHAPES = ((2, 6, 10, 196), (2, 96, 160, 32))


@pytest.fixture
def cuda_device():
    """The card; the CUDA kernels have no CPU mode, so skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cost_volume_kernel_matches_plain(cuda_device, shape):
    # float32: sums in other orders, 1e-5 on costs ~0.1; bfloat16: one ulp of
    # the largest cost (both sum in float32 and round once)
    rs = np.random.RandomState(0)
    a, b = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda_device)
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((2, 12, 20, 128), (2, 96, 160, 32)))
def test_warp_kernel_bit_equal_to_plain(cuda_device, shape):
    # the kernel repeats the plain version's arithmetic op for op
    rs = np.random.RandomState(1)
    image = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda_device)
    flow = torch.from_numpy(clamp_flow(rs, *shape[:3])).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        im, fl = image.to(dtype), flow.to(dtype)
        before = dense_image_warp.launches
        got = dense_image_warp(im, fl)
        torch.cuda.synchronize()
        assert dense_image_warp.launches == before + 1
        assert torch.equal(got, warp_plain(im, fl))
