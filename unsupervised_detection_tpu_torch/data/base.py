"""Dataset abstractions: sequence lists and pair index tables.

The port's own copy of unsupervised_detection_tpu/data/base.py. The
reference builds tf.data pipelines from index tables of
(frame_number, direction) rows, where boundary frames pair backward in time
and everything else pairs forward (data/davis2016_data_utils.py:180-291).
This module reproduces those tables as plain numpy; the host loader
(loader.py) consumes them with a decode thread pool.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SequenceDataset:
    """A dataset as per-sequence frame and annotation path lists."""

    name: str
    sequences: List[str]                      # sequence (category) names
    image_files: List[List[str]]              # per sequence
    annotation_files: List[List[Optional[str]]]
    # FBMS-style sparse GT: optional per-sequence sample counts used for
    # class-imbalance-aware scoring (fbms_data_utils.py:1-11).
    samples_per_category: Optional[dict] = None

    @property
    def num_samples(self) -> int:
        return sum(len(f) for f in self.image_files)

    def flat_images(self) -> np.ndarray:
        return np.asarray([p for seq in self.image_files for p in seq])

    def flat_annotations(self) -> np.ndarray:
        return np.asarray(
            [p if p is not None else "" for seq in self.annotation_files for p in seq]
        )

    def flat_categories(self) -> np.ndarray:
        out = []
        for name, seq in zip(self.sequences, self.image_files):
            out.extend([name] * len(seq))
        return np.asarray(out)


@dataclasses.dataclass
class PairIndex:
    """(frame_number, direction) table plus the flat file arrays."""

    numbers: np.ndarray      # int32 [N]
    directions: np.ndarray   # int32 [N], +1 forward / -1 backward
    images: np.ndarray       # flat path array (indexed by numbers)
    annotations: Optional[np.ndarray]
    categories: Optional[np.ndarray]

    def __len__(self):
        return len(self.numbers)


def train_pair_index(ds: SequenceDataset, max_temporal_len: int) -> PairIndex:
    """Training table (davis2016_data_utils.py:196-215): frames that can look
    `max_temporal_len` forward get direction +1, frames that can look backward
    get -1; interior frames appear in both lists."""
    t = max_temporal_len
    firsts, lasts = [], []
    n = 0
    for files in ds.image_files:
        m = len(files)
        firsts.append(np.arange(n, n + max(m - t, 0), dtype=np.int32))
        lasts.append(np.arange(n + t, n + m, dtype=np.int32))
        n += m
    first = np.concatenate(firsts) if firsts else np.zeros((0,), np.int32)
    last = np.concatenate(lasts) if lasts else np.zeros((0,), np.int32)
    numbers = np.concatenate([first, last])
    directions = np.concatenate(
        [np.ones_like(first), -np.ones_like(last)]
    )
    return PairIndex(numbers, directions, ds.flat_images(), None, None)


def test_pair_index(ds: SequenceDataset, t_len: int) -> PairIndex:
    """Test table (davis2016_data_utils.py:253-267): every frame exactly once;
    the |t_len| frames that cannot pair in the requested direction pair
    backward instead."""
    firsts, lasts = [], []
    n = 0
    for files in ds.image_files:
        m = len(files)
        if t_len < 0:
            lasts.append(np.arange(n + abs(t_len), n + m, dtype=np.int32))
            firsts.append(np.arange(n, n + abs(t_len), dtype=np.int32))
        elif t_len > 0:
            firsts.append(np.arange(n, n + m - t_len, dtype=np.int32))
            lasts.append(np.arange(n + m - t_len, n + m, dtype=np.int32))
        n += m
    first = np.concatenate(firsts) if firsts else np.zeros((0,), np.int32)
    last = np.concatenate(lasts) if lasts else np.zeros((0,), np.int32)
    numbers = np.concatenate([first, last])
    directions = np.concatenate([np.ones_like(first), -np.ones_like(last)])
    return PairIndex(
        numbers, directions, ds.flat_images(), ds.flat_annotations(),
        ds.flat_categories(),
    )
