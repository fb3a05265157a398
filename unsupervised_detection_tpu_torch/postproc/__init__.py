"""Post-processing of the port, counterpart of
unsupervised_detection_tpu/postproc: soft scores from the ensemble's
buffers, flow-propagated running averages, and the dense CRF."""

from .crf import refine_mask, run_crf
from .propagate import propagate_sequences, warp_with_flow
from .soft_score import buffer_to_soft_score, rectify_pred_mask, sanity_check

__all__ = ["buffer_to_soft_score", "rectify_pred_mask", "sanity_check",
           "propagate_sequences", "warp_with_flow", "run_crf", "refine_mask"]
