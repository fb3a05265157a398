"""The flagship's raw J-mean through the port's CLI, on the CPU in float32.

The gate of experiments/e2e_jmean/REPORT.md: the 5 sequences x 24 frames
that tools/exp_e2e_jmean.py renders (seed 17, as the tool calls it), the
committed flagship checkpoints (experiments/game_state_v2lr/model.best +
experiments/pwc_ckpt_v2/pwc-final, search range 2) exported by
tools/export_torch_checkpoint.py, and the tool's own raw-stage flags
(reader = working = 192x384, batch 8, temporal shift 1, test_crop 0.9).
"""

import importlib.util
import os

import numpy as np
import pytest

from torch_parity import GAME_CKPT, PWC_CKPT, REPO, committed_checkpoints, torch_threads
from unsupervised_detection_tpu.config import parse_flags as jax_parse_flags
from unsupervised_detection_tpu.eval.evaluator import Evaluator as JaxEvaluator
from unsupervised_detection_tpu.eval.evaluator import evaluate_dataset as jax_evaluate_dataset
from unsupervised_detection_tpu_torch.eval import Evaluator
from unsupervised_detection_tpu_torch.test_generator import main

_threads = torch_threads(2)

# Raw float32 J-mean of the flagship, dataset and per sequence
# (experiments/e2e_jmean/REPORT.md:13 and :24-28).
REPORT_DATASET_IOU = 0.6984
REPORT_SEQUENCE_IOU = {"pan_a": 0.6537, "zoom_b": 0.7459, "drift_c": 0.7278,
                       "shear_d": 0.7367, "wobble_e": 0.6276}
# Tolerances, fixed before the first run: the frames are JPEGs encoded by
# the cv2 at hand, which may differ from the one that rendered the report,
# and the report rounds to 4 digits: |dIoU| <= 0.005 for the dataset and
# <= 0.01 per sequence.
DATASET_TOL = 0.005
SEQUENCE_TOL = 0.01
# Per frame against the JAX evaluate_dataset on the same files: float32
# conv sums in other orders (tests/test_torch_main_path.py): 1e-3.
FRAME_TOL = 1e-3
SEQUENCE = "wobble_e"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """(out_root, flags, jmean tool): the rendered tree under out_root/DAVIS,
    the exported checkpoint and the raw stage's float32 flags."""
    jmean = _tool("exp_e2e_jmean")
    out_root = str(tmp_path_factory.mktemp("e2e_jmean"))
    jmean.render_dataset(os.path.join(out_root, "DAVIS"))
    ckpt = os.path.join(out_root, "flagship.npz")
    assert _tool("export_torch_checkpoint").main([ckpt, GAME_CKPT, PWC_CKPT]) == 0
    return out_root, jmean._common_flags(out_root, ckpt, "float32"), jmean


def _record(monkeypatch, owner, frames):
    """Record each batch's categories and per-frame (IoU, MAE) in `frames`
    by wrapping `device_batch` and `infer_metrics` of `owner`: the port's
    Evaluator class (main builds its instance) or a JAX evaluator
    instance. The batch is the last argument either way."""
    device_batch, infer = owner.device_batch, owner.infer_metrics

    def recording_batch(*args):
        frames["category"] += list(args[-1]["category"])
        return device_batch(*args)

    def recording_infer(*args):
        out = infer(*args)
        frames["metrics"].append(np.stack([np.asarray(out["iou"]), np.asarray(out["mae"])], 1))
        return out

    monkeypatch.setattr(owner, "device_batch", recording_batch)
    monkeypatch.setattr(owner, "infer_metrics", recording_infer)


def test_flagship_raw_jmean_on_cpu(gate, tmp_path, monkeypatch, capsys):
    out_root, flags, jmean = gate
    port = {"category": [], "metrics": []}
    _record(monkeypatch, Evaluator, port)
    res = main(flags, device="cpu")
    out = capsys.readouterr().out

    # the CLI's lines, read as the J-mean tool reads them
    dataset_iou = jmean.parse_avg_iou(out)
    per_seq = jmean.parse_category_ious(out)
    assert res["frames"] == 120 and list(per_seq) == list(REPORT_SEQUENCE_IOU)
    assert abs(dataset_iou - REPORT_DATASET_IOU) <= DATASET_TOL, (dataset_iou, per_seq)
    for seq, want in REPORT_SEQUENCE_IOU.items():
        assert abs(per_seq[seq] - want) <= SEQUENCE_TOL, (seq, per_seq[seq], want)

    # one sequence frame by frame against the JAX evaluate_dataset on the
    # same files: a tree whose val partition lists only that sequence
    davis = os.path.join(out_root, "DAVIS")
    one = tmp_path / "DAVIS"
    (one / "ImageSets" / "480p").mkdir(parents=True)
    for sub in ("JPEGImages", "Annotations"):
        os.symlink(os.path.join(davis, sub), one / sub)
    lines = [ln for ln in open(os.path.join(davis, "ImageSets", "480p", "val.txt"))
             if f"/{SEQUENCE}/" in ln]
    (one / "ImageSets" / "480p" / "val.txt").write_text("".join(lines))
    jax_cfg = jax_parse_flags(flags).replace(root_dir=str(one))
    jax_ev = JaxEvaluator(jax_cfg)
    jax_frames = {"category": [], "metrics": []}
    _record(monkeypatch, jax_ev, jax_frames)
    gen_p, gen_s, pwc_p = committed_checkpoints()
    state = type("State", (), dict(gen_params=gen_p, gen_stats=gen_s, pwc_params=pwc_p))
    want = jax_evaluate_dataset(jax_cfg, state, evaluator=jax_ev, verbose=False)

    assert jax_frames["category"] == [SEQUENCE] * 24 and want["frames"] == 24
    rows = [i for i, c in enumerate(port["category"]) if c == SEQUENCE]
    assert len(rows) == 24
    got_f = np.concatenate(port["metrics"])[rows]
    want_f = np.concatenate(jax_frames["metrics"])
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=FRAME_TOL)
    assert abs(per_seq[SEQUENCE] - want["category_iou"][SEQUENCE]) <= FRAME_TOL
