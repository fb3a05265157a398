"""FBMS59 dataset reader (the port's copy of
unsupervised_detection_tpu/data/fbms.py; cv2 is imported where it is used,
so the package imports on a host without it).

Reproduces the reference reader (data/fbms_data_utils.py): per-category
`.bmf` index files (skip first line, extensions rewritten to .jpg), sparse
ground truth discovered under GroundTruth/ with two layouts (pgm-indexed or
the "weird" ppm layout), one-time GT binarization with per-sequence
thresholds (marple7=0.05, marple2=0.4, else 0.1; the ppm layout also zeroes
values > 0.99), and offset clamping that keeps test pairs inside the
sequence. Test samples exist only at annotated frames; `samples_per_cat`
feeds class-imbalance-aware scoring.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np

from .base import SequenceDataset

_PARTITIONS = {
    "train": ["Trainingset"],
    "val": ["Testset"],
    "trainval": ["Trainingset", "Testset"],
}


def _read_bmf(data_dir: str, folder_name: str) -> List[str]:
    bmf = os.path.join(data_dir, folder_name, folder_name + ".bmf")
    if not os.path.isfile(bmf):
        raise IOError("Not found file {}".format(bmf))
    names = np.loadtxt(bmf, dtype=str, skiprows=1, ndmin=1)
    names = [f.split(".")[0] + ".jpg" for f in names]
    return [os.path.join(data_dir, folder_name, f) for f in names]


def find_gt(directory: str) -> Tuple[List[str], List[int], bool]:
    """Discover annotation files + their frame numbers
    (fbms_data_utils.py:152-174)."""
    all_files = os.listdir(directory)
    type_weird = any(f.endswith("ppm") for f in all_files)
    if not type_weird:
        files = [f for f in all_files if f.endswith("pgm")]
        try:
            files = sorted(files, key=lambda x: int(x.split(".")[0].split("_")[-1]))
            numbers = [int(f.split(".")[0].split("_")[-1]) for f in files]
        except ValueError:
            files = sorted(files, key=lambda x: int(re.search(r"\d+", x).group()))
            numbers = [int(re.search(r"\d+", f).group()) for f in files]
        return files, numbers, type_weird
    files = [f for f in all_files if f.endswith("ppm") and "PROB" not in f]
    files = sorted(files, key=lambda x: int(x.split("_")[1]))
    numbers = [int(f.split("_")[1]) for f in files]
    return files, numbers, type_weird


def preprocess_gt_once(gt_dir: str, folder_name: str) -> Tuple[List[str], List[int]]:
    """Binarize raw GT into .jpg masks next to the originals
    (fbms_data_utils.py:109-125). Idempotent: skips files already written."""
    import cv2

    files, numbers, type_weird = find_gt(gt_dir)
    goal = [os.path.join(gt_dir, f.split(".")[0] + ".jpg") for f in files]
    for src, dst in zip(files, goal):
        if os.path.isfile(dst):
            continue
        mask = cv2.imread(os.path.join(gt_dir, src))
        mask = cv2.cvtColor(mask, cv2.COLOR_BGR2GRAY) / 255.0
        if type_weird:
            mask[mask > 0.99] = 0.0
        if folder_name == "marple7":
            mask = mask > 0.05
        elif folder_name == "marple2":
            mask = mask > 0.4
        else:
            mask = mask > 0.1
        cv2.imwrite(dst, np.asarray(mask * 255, dtype=np.uint8))
    return goal, numbers


class FBMS59Reader:
    # FBMS frames vary in size; loaders resize per-sample on host.
    raw_height = None
    raw_width = None

    def __init__(self, root_dir: str, max_temporal_len: int = 3,
                 min_temporal_len: int = 2, num_threads: int = 6):
        self.root_dir = root_dir
        self.max_temporal_len = max_temporal_len
        self.min_temporal_len = min_temporal_len
        assert min_temporal_len < max_temporal_len, "Temporal lengths are not consistent"
        assert min_temporal_len > 0, "Min temporal len should be positive"
        self.num_threads = num_threads

    def dataset(self, partition: str = "train") -> SequenceDataset:
        """Training dataset: all frames per category, no annotations."""
        sequences, image_files, annotation_files = [], [], []
        for part_dir in _PARTITIONS[partition]:
            d = os.path.join(self.root_dir, part_dir)
            if not os.path.isdir(d):
                raise IOError("Directory {} file not found".format(d))
            for folder_name in os.listdir(d):
                files = _read_bmf(d, folder_name)
                sequences.append(folder_name)
                image_files.append(files)
                annotation_files.append([None] * len(files))
        ds = SequenceDataset("FBMS", sequences, image_files, annotation_files)
        if ds.num_samples == 0:
            raise IOError("Did not find any file in the dataset folder")
        return ds

    def test_tuples(self, partition: str = "val", test_temporal_t: int = 1):
        """(img1, img2, annotation, category, samples_per_cat) test tuples at
        annotated frames only, with boundary-clamped offsets
        (fbms_data_utils.py:127-149)."""
        tuples = []
        samples_per_cat = {}
        for part_dir in _PARTITIONS[partition]:
            d = os.path.join(self.root_dir, part_dir)
            if not os.path.isdir(d):
                raise IOError("Directory {} file not found".format(d))
            for folder_name in os.listdir(d):
                files = _read_bmf(d, folder_name)
                gt_dir = os.path.join(d, folder_name, "GroundTruth")
                goal_annotations, numbers = preprocess_gt_once(gt_dir, folder_name)

                numbers = np.array(numbers) - np.min(numbers)
                seq_len = np.max(numbers)
                offsets = numbers + test_temporal_t
                if offsets[0] < numbers[0]:
                    offsets[0] += 2 * abs(test_temporal_t)
                if offsets[-1] > numbers[-1]:
                    offsets[-1] -= 2 * abs(test_temporal_t)
                offsets = np.clip(offsets, 0, seq_len)

                for i, k in enumerate(numbers):
                    tuples.append(
                        (files[k], files[offsets[i]], goal_annotations[i],
                         folder_name, len(goal_annotations))
                    )
                samples_per_cat[folder_name] = len(goal_annotations)
        self.samples_per_cat = samples_per_cat
        self.num_categories = len(samples_per_cat)
        return tuples
