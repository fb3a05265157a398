"""SegTrackV2 dataset reader (the port's copy of
unsupervised_detection_tpu/data/segtrack.py).

Reproduces the reference reader (data/segtrackv2_data_utils.py:11-70):
`ImageSets/all.txt` lists experiments (leading character stripped), each
`ImageSets/<experiment>.txt` lists frame stems (first line skipped); images
live in JPEGImages/<experiment>/<stem>.png and ground truth in
GroundTruth/<experiment>/<stem>.png. There are no partitions
(train = test = all); file existence is asserted at parse time.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .base import SequenceDataset


class SegTrackV2Reader:
    # SegTrack frames vary in size; loaders resize per-sample on host.
    raw_height = None
    raw_width = None

    def __init__(self, root_dir: str, max_temporal_len: int = 3,
                 min_temporal_len: int = 2, num_threads: int = 6):
        self.root_dir = root_dir
        self.max_temporal_len = max_temporal_len
        self.min_temporal_len = min_temporal_len
        self.num_threads = num_threads

    def dataset(self, partition: str = "all") -> SequenceDataset:
        del partition  # SegTrackV2 has no partitions
        all_files = os.path.join(self.root_dir, "ImageSets/all.txt")
        if not os.path.isfile(all_files):
            raise IOError("Division file not found")
        experiments = [c[1:] for c in np.loadtxt(all_files, dtype=str, ndmin=1)]

        image_dir = os.path.join(self.root_dir, "JPEGImages")
        annotation_dir = os.path.join(self.root_dir, "GroundTruth")
        sequences: List[str] = []
        image_files: List[List[str]] = []
        annotation_files: List[List[str]] = []
        for experiment in experiments:
            exp_file = os.path.join(self.root_dir, "ImageSets", experiment + ".txt")
            assert os.path.isfile(exp_file), "Experiment {} not found".format(exp_file)
            stems = np.loadtxt(exp_file, dtype=str, skiprows=1, ndmin=1)
            imgs, anns = [], []
            for stem in stems:
                imgs.append(os.path.join(image_dir, experiment, stem + ".png"))
                assert os.path.isfile(imgs[-1]), "Not found image {}".format(imgs[-1])
                anns.append(os.path.join(annotation_dir, experiment, stem + ".png"))
                assert os.path.isfile(anns[-1]), "Not found image {}".format(anns[-1])
            sequences.append(experiment)
            image_files.append(imgs)
            annotation_files.append(anns)

        ds = SequenceDataset("SEGTRACK", sequences, image_files, annotation_files)
        if ds.num_samples == 0:
            raise IOError("Did not find any file in the dataset folder")
        print(
            "Found {} images belonging to {} experiments.".format(
                ds.num_samples, len(sequences)
            )
        )
        return ds
