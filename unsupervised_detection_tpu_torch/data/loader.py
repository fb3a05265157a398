"""Host-side data loading: decode threads and an ordered prefetch queue.

Counterpart of unsupervised_detection_tpu/data/loader.py: `HostLoader`,
`TrainPipeline`, `TestPipeline`, `host_resize_image`, `host_resize_mask`.
The host only decodes compressed frames, except in host mode.

Two feed modes:
  * raw mode (datasets with a uniform raw frame size, e.g. DAVIS): batches
    are uint8 at the size the frames decode to; `DeviceFeeder` casts and
    resizes them on the device;
  * host mode (FBMS/SegTrack with per-sequence sizes): frames are resized on
    the host to the reader size with the TF-parity weights of the port's
    ops/resize.py, the same matrices the device uses.

Under a data-parallel mesh every rank runs the same seeded pipeline, so
the global batches and their order are those of one process; with `rows`
(lo, hi) a pipeline decodes only those rows of each batch and says so in
the batch's `rows` entry (`category` and `fname` stay the global batch's).

cv2 is imported where frames are decoded, so the package imports on a host
without it. The pipelines take `read_rgb` (and `read_gray`) decode hooks,
so a caller that holds frames in memory can feed them without files.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
import functools
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from ..ops.resize import bilinear_resize_weights_np, nearest_resize_index_np
from .base import SequenceDataset, test_pair_index, train_pair_index


def _imread_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError("Failed to decode {}".format(path))
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _imread_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError("Failed to decode {}".format(path))
    return img[..., None]


@functools.lru_cache(maxsize=64)
def _resize_weights(in_h: int, in_w: int, out_h: int, out_w: int):
    return (
        bilinear_resize_weights_np(in_h, out_h),
        bilinear_resize_weights_np(in_w, out_w),
    )


def host_resize_image(img_u8: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC -> float32 reader-size in [-0.5, 0.5], TF-parity bilinear
    (reference preprocess_image, davis2016_data_utils.py:86-91)."""
    x = img_u8.astype(np.float32) / 255.0 - 0.5
    wh, ww = _resize_weights(x.shape[0], x.shape[1], *out_hw)
    return np.einsum("oh,hwc->owc", wh, np.einsum("pw,hwc->hpc", ww, x))


def host_resize_mask(mask_u8: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HW1 -> float32 reader-size mask in [0, 1], NN resize
    (reference preprocess_mask, davis2016_data_utils.py:93-99)."""
    m = mask_u8.astype(np.float32) / 255.0
    ih = nearest_resize_index_np(m.shape[0], out_hw[0])
    iw = nearest_resize_index_np(m.shape[1], out_hw[1])
    return m[ih][:, iw]


class HostLoader:
    """Thread-pooled batch producer with bounded, ordered prefetch."""

    def __init__(self, num_threads: int = 6, prefetch: int = 3):
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch

    def prefetched(self, batch_specs: Iterator, make_batch) -> Iterator:
        """Map make_batch over batch_specs with `prefetch` batches in flight,
        yielding results in spec order. The pool lives for one pass: it is
        shut down when the pass ends or its consumer stops early."""
        pending = collections.deque()
        specs = iter(batch_specs)
        pool = futures.ThreadPoolExecutor(max_workers=self.num_threads)
        try:
            for spec in specs:
                pending.append(pool.submit(make_batch, spec))
                if len(pending) == self.prefetch:
                    break
            while pending:
                done = pending.popleft()
                spec = next(specs, None)
                if spec is not None:
                    pending.append(pool.submit(make_batch, spec))
                yield done.result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


class TrainPipeline:
    """Infinite shuffled stream of frame pairs with a random temporal shift.

    The sampling of the reference train pipeline
    (davis2016_data_utils.py:148-229): a `np.random.RandomState(seed)`
    permutation of the pair index per epoch, batches of `batch_size` with
    the remainder dropped, and per sample a shift t ~ U{min_temporal_len..
    max_temporal_len} along the row's direction. Yields dict batches
    (`img1_raw`/`img2_raw` uint8 in raw mode, `img1`/`img2` float32 at the
    reader size in host mode); augmentation happens on the device. With
    `rows`, only those rows of each batch are decoded.
    """

    def __init__(self, dataset: SequenceDataset, batch_size: int,
                 min_temporal_len: int, max_temporal_len: int,
                 reader_hw: Tuple[int, int] = (384, 640),
                 raw_hw: Optional[Tuple[int, int]] = None,
                 num_threads: int = 6, seed: int = 8964,
                 read_rgb: Callable[[str], np.ndarray] = _imread_rgb,
                 rows: Optional[Tuple[int, int]] = None):
        self.index = train_pair_index(dataset, max_temporal_len)
        self.batch_size = batch_size
        self.min_t = min_temporal_len
        self.max_t = max_temporal_len
        self.reader_hw = reader_hw
        self.raw_hw = raw_hw
        self.read_rgb = read_rgb
        self.rng = np.random.RandomState(seed)
        self.rows = rows
        self.loader = HostLoader(num_threads, prefetch=3)

    def _spec_stream(self):
        n = len(self.index)
        while True:
            order = self.rng.permutation(n)
            for start in range(0, n - self.batch_size + 1, self.batch_size):
                rows = order[start : start + self.batch_size]
                shifts = self.rng.randint(self.min_t, self.max_t + 1, size=len(rows))
                idx1 = self.index.numbers[rows]
                idx2 = idx1 + shifts * self.index.directions[rows]
                yield idx1, idx2

    def _make_batch(self, spec):
        idx1, idx2 = spec
        extra = {}
        if self.rows is not None:
            idx1, idx2 = idx1[self.rows[0]:self.rows[1]], idx2[self.rows[0]:self.rows[1]]
            extra = {"rows": self.rows}
        rgb = self.read_rgb
        if self.raw_hw is not None:
            img1 = np.stack([rgb(self.index.images[i]) for i in idx1])
            img2 = np.stack([rgb(self.index.images[i]) for i in idx2])
            return {"img1_raw": img1, "img2_raw": img2, **extra}
        img1 = np.stack([host_resize_image(rgb(self.index.images[i]), self.reader_hw)
                         for i in idx1])
        img2 = np.stack([host_resize_image(rgb(self.index.images[i]), self.reader_hw)
                         for i in idx2])
        return {"img1": img1, "img2": img2, **extra}

    def __iter__(self):
        return self.loader.prefetched(self._spec_stream(), self._make_batch)


class TestPipeline:
    __test__ = False  # not a pytest class

    """Sequential (cyclically wrapped) evaluation stream with ground truth.

    Matches reference test_inputs semantics: fixed |t_len| shift with
    boundary reversal, every frame exactly once per cycle, final batch
    filled by wrap-around (the reference's repeat(None) + ceil(n/b) steps,
    test_generator.py:62-75). Yields images, GT mask, category and file name
    per sample.

    `read_rgb` / `read_gray` decode a frame / mask name to uint8 HWC / HW1
    (default: cv2 from files); a caller that holds frames in memory passes
    its own lookups. With `rows`, only those rows of each batch are decoded.
    """

    def __init__(self, dataset: Optional[SequenceDataset], batch_size: int, t_len: int,
                 reader_hw: Tuple[int, int] = (384, 640),
                 raw_hw: Optional[Tuple[int, int]] = None,
                 num_threads: int = 1,
                 explicit_tuples: Optional[List] = None,
                 read_rgb: Callable[[str], np.ndarray] = _imread_rgb,
                 read_gray: Callable[[str], np.ndarray] = _imread_gray,
                 rows: Optional[Tuple[int, int]] = None):
        if explicit_tuples is not None:
            # FBMS-style (img1, img2, ann, category, samples_per_cat) tuples.
            self.tuples = explicit_tuples
            self.num_samples = len(explicit_tuples)
        else:
            self.index = test_pair_index(dataset, t_len)
            self.t_len = abs(t_len)
            self.tuples = None
            self.num_samples = len(self.index)
        self.batch_size = batch_size
        self.reader_hw = reader_hw
        self.raw_hw = raw_hw
        self.read_rgb, self.read_gray = read_rgb, read_gray
        self.rows = rows
        self.loader = HostLoader(num_threads, prefetch=3)

    @property
    def num_steps(self) -> int:
        return int(np.ceil(self.num_samples / float(self.batch_size)))

    def _sample(self, i: int):
        if self.tuples is not None:
            f1, f2, ann, cat, _ = self.tuples[i]
            return f1, f2, ann, cat
        n1 = self.index.numbers[i]
        n2 = n1 + self.t_len * self.index.directions[i]
        return (
            self.index.images[n1],
            self.index.images[n2],
            self.index.annotations[n1],
            self.index.categories[n1],
        )

    def _make_batch(self, rows):
        f1s, f2s, anns, cats = zip(*[self._sample(i) for i in rows])
        meta = {"category": list(cats), "fname": list(f1s)}
        if self.rows is not None:
            lo, hi = self.rows
            f1s, f2s, anns = f1s[lo:hi], f2s[lo:hi], anns[lo:hi]
            meta["rows"] = self.rows
        rgb, gray = self.read_rgb, self.read_gray
        if self.raw_hw is not None:
            img1 = np.stack([rgb(f) for f in f1s])
            img2 = np.stack([rgb(f) for f in f2s])
            gt = np.stack([gray(a) for a in anns])
            return {"img1_raw": img1, "img2_raw": img2, "gt_raw": gt, **meta}
        img1 = np.stack([host_resize_image(rgb(f), self.reader_hw) for f in f1s])
        img2 = np.stack([host_resize_image(rgb(f), self.reader_hw) for f in f2s])
        gt = np.stack([host_resize_mask(gray(a), self.reader_hw) for a in anns])
        return {"img1": img1, "img2": img2, "gt": gt, **meta}

    def _spec_stream(self):
        order = np.arange(self.num_samples)
        for step in range(self.num_steps):
            start = step * self.batch_size
            rows = [order[(start + j) % self.num_samples] for j in range(self.batch_size)]
            yield rows

    def __iter__(self):
        return self.loader.prefetched(self._spec_stream(), self._make_batch)
