"""DAVIS2016 dataset reader (the port's copy of
unsupervised_detection_tpu/data/davis.py).

Parses ImageSets/480p/{train,val,trainval}.txt into per-sequence file lists
exactly like the reference DirectoryIterator
(data/davis2016_data_utils.py:6-65): each line holds
"/JPEGImages/480p/<seq>/<frame>.jpg /Annotations/480p/<seq>/<frame>.png",
sequence name at path component 3, paths are repo-root-relative with a
leading slash.
"""

from __future__ import annotations

import os
from typing import List

from .base import SequenceDataset

_PARTITION_FILES = {
    "train": "ImageSets/480p/train.txt",
    "val": "ImageSets/480p/val.txt",
    "trainval": "ImageSets/480p/trainval.txt",
}


class Davis2016Reader:
    # DAVIS 480p raw frame size. Only its presence matters: it selects the
    # raw feed mode, which stacks whatever size the frames decode to.
    raw_height = 480
    raw_width = 854

    def __init__(self, root_dir: str, max_temporal_len: int = 3,
                 min_temporal_len: int = 1, num_threads: int = 6):
        self.root_dir = root_dir
        self.max_temporal_len = max_temporal_len
        self.min_temporal_len = min_temporal_len
        assert min_temporal_len < max_temporal_len, "Temporal lengths are not consistent"
        assert min_temporal_len > 0, "Min temporal len should be positive"
        self.num_threads = num_threads

    def dataset(self, partition: str = "train") -> SequenceDataset:
        part_file = os.path.join(self.root_dir, _PARTITION_FILES[partition])
        if not os.path.isfile(part_file):
            raise IOError("Partition file not found")

        sequences: List[str] = []
        image_files: List[List[str]] = []
        annotation_files: List[List[str]] = []
        with open(part_file) as fh:
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                img_rel, ann_rel = parts[0], parts[1]
                seq = img_rel.split("/")[3]
                if not sequences or sequences[-1] != seq:
                    sequences.append(seq)
                    image_files.append([])
                    annotation_files.append([])
                image_files[-1].append(os.path.join(self.root_dir, img_rel[1:]))
                annotation_files[-1].append(os.path.join(self.root_dir, ann_rel[1:]))

        ds = SequenceDataset("DAVIS2016", sequences, image_files, annotation_files)
        if ds.num_samples == 0:
            raise IOError("Did not find any file in the dataset folder")
        print(
            "Found {} images belonging to {} experiments.".format(
                ds.num_samples, len(sequences)
            )
        )
        return ds
