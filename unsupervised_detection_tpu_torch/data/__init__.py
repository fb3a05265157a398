"""Datasets and host feeding of the port, counterpart of
unsupervised_detection_tpu/data."""

from .base import PairIndex, SequenceDataset
from .davis import Davis2016Reader
from .fbms import FBMS59Reader
from .loader import HostLoader, TestPipeline, TrainPipeline
from .segtrack import SegTrackV2Reader

__all__ = ["PairIndex", "SequenceDataset", "Davis2016Reader", "FBMS59Reader",
           "SegTrackV2Reader", "HostLoader", "TestPipeline", "TrainPipeline",
           "get_reader"]


def get_reader(dataset: str, root_dir: str, **kw):
    """Dataset dispatch (adversarial_learner.py:22-67)."""
    if dataset == "DAVIS2016":
        return Davis2016Reader(root_dir, **kw)
    if dataset == "FBMS":
        return FBMS59Reader(root_dir, **kw)
    if dataset == "SEGTRACK":
        return SegTrackV2Reader(root_dir, **kw)
    raise IOError("Dataset should be DAVIS2016 / FBMS / SEGTRACK")
