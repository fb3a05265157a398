"""Host batch -> device tensors, counterpart of
unsupervised_detection_tpu/data/device_input.py.

Raw-mode batches (uint8 at the decoded size) cross to the device as uint8
and are cast and resized there to the reader resolution (reference
preprocess_image / preprocess_mask, davis2016_data_utils.py:86-99):
`x / 255 - 0.5` then TF1-legacy bilinear for images, `m / 255` then
nearest for masks. Host-mode batches arrive preprocessed
(data/loader.py) and are only copied. Images stay float32, as in the JAX
package, whatever the model's compute dtype.

On a mesh (parallel/mesh.py) only this rank's rows of the global batch
cross to the device: a batch that a pipeline decoded for these rows only
carries them as `rows` (data/loader.py); any other batch is the global
one and is sliced here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import precision_scope, resolve_device
from ..ops.resize import resize_bilinear, resize_nearest
from ..parallel.mesh import Mesh


class DeviceFeeder:
    """Preprocessing bound to one device, a reader resolution and this
    rank's `mesh` (None: the trivial one).

    `device=None` means the first CUDA device and raises without one. To a
    CUDA device, host arrays go through pinned memory with non-blocking
    copies; on the CPU they are used in place. The resize is a matmul, run
    with TF32 off (`device.precision_scope`) so it stays float32."""

    def __init__(self, reader_hw, device=None, mesh: Mesh | None = None):
        self.reader_hw = tuple(reader_hw)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else Mesh()

    def _rows(self, batch, key: str) -> np.ndarray:
        """This rank's rows of `batch[key]`."""
        if "rows" not in batch:
            return self.mesh.shard(batch[key])
        lo, hi = batch["rows"]
        if (lo, hi) != self.mesh.rows((hi - lo) * self.mesh.n_data):
            raise ValueError(f"a batch of rows [{lo}, {hi}) on data index "
                             f"{self.mesh.data_index} of {self.mesh.n_data}")
        return batch[key]

    def _put(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _preprocess(self, img_raw: np.ndarray) -> torch.Tensor:
        x = self._put(img_raw).float() / 255.0 - 0.5
        with precision_scope(torch.float32):
            return resize_bilinear(x, self.reader_hw)

    def _preprocess_mask(self, gt_raw: np.ndarray) -> torch.Tensor:
        m = self._put(gt_raw).float() / 255.0
        with precision_scope(torch.float32):
            return resize_nearest(m, self.reader_hw)

    def images(self, batch):
        """(img1, img2) at reader resolution on the device: this rank's
        rows."""
        if "img1_raw" in batch:
            return (self._preprocess(self._rows(batch, "img1_raw")),
                    self._preprocess(self._rows(batch, "img2_raw")))
        return self._put(self._rows(batch, "img1")), self._put(self._rows(batch, "img2"))

    def mask(self, batch) -> torch.Tensor:
        if "gt_raw" in batch:
            return self._preprocess_mask(self._rows(batch, "gt_raw"))
        return self._put(self._rows(batch, "gt"))
