"""The flagship's raw J-mean through the port's CLI, on the CPU in float32.

The gate of experiments/e2e_jmean/REPORT.md: the 5 sequences x 24 frames
that tools/exp_e2e_jmean.py renders (seed 17, as the tool calls it), the
committed flagship checkpoints (experiments/game_state_v2lr/model.best +
experiments/pwc_ckpt_v2/pwc-final, search range 2) exported by
tools/export_torch_checkpoint.py, and the tool's own raw-stage flags
(reader = working = 192x384, batch 8, temporal shift 1, test_crop 0.9),
run through the raw stage of the port's chain
(unsupervised_detection_tpu_torch/e2e_jmean.py). The chain's committed
weights and its renderer are held to the exporter's and the tool's.
"""

import importlib.util
import os

import cv2
import numpy as np
import pytest

from torch_parity import GAME_CKPT, PWC_CKPT, REPO, committed_checkpoints, torch_threads
from unsupervised_detection_tpu.config import parse_flags as jax_parse_flags
from unsupervised_detection_tpu.eval.evaluator import Evaluator as JaxEvaluator
from unsupervised_detection_tpu.eval.evaluator import evaluate_dataset as jax_evaluate_dataset
from unsupervised_detection_tpu_torch import e2e_jmean
from unsupervised_detection_tpu_torch.eval import Evaluator

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
    """(out_root, checkpoint, jmean tool): the tool's rendered tree under
    out_root/DAVIS and a fresh export of the flagship checkpoints."""
    jmean = _tool("exp_e2e_jmean")
    out_root = str(tmp_path_factory.mktemp("e2e_jmean"))
    jmean.render_dataset(os.path.join(out_root, "DAVIS"))
    ckpt = os.path.join(out_root, "flagship.npz")
    assert _tool("export_torch_checkpoint").main([ckpt, GAME_CKPT, PWC_CKPT]) == 0
    return out_root, ckpt, jmean


def test_committed_weights_equal_a_fresh_export(gate):
    # the chain's default checkpoint holds the same arrays as the export of
    # the committed JAX saves
    _, ckpt, _ = gate
    assert e2e_jmean.CKPT_FILE == os.path.join(REPO, "weights_torch", "flagship_v2lr_r2.npz")
    with np.load(e2e_jmean.CKPT_FILE) as got, np.load(ckpt) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_port_renders_the_tools_tree(gate, tmp_path):
    out_root, _, _ = gate
    want_root = os.path.join(out_root, "DAVIS")
    got_root = str(tmp_path / "DAVIS")
    e2e_jmean.render_dataset(got_root)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)

    names = files(want_root)
    assert files(got_root) == names and len(names) == 3 + 2 * 120
    for name in names:
        got, want = os.path.join(got_root, name), os.path.join(want_root, name)
        if name.endswith(".txt"):
            assert open(got).read() == open(want).read(), name
        else:
            np.testing.assert_array_equal(cv2.imread(got, cv2.IMREAD_UNCHANGED),
                                          cv2.imread(want, cv2.IMREAD_UNCHANGED),
                                          err_msg=name)


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


def test_flagship_raw_jmean_on_cpu(gate, tmp_path, monkeypatch):
    out_root, ckpt, jmean = gate
    flags = jmean._common_flags(out_root, ckpt, "float32")
    assert e2e_jmean.common_flags(out_root, ckpt, "float32") == flags
    port = {"category": [], "metrics": []}
    _record(monkeypatch, Evaluator, port)
    res = e2e_jmean.raw_stage(out_root, ckpt, "float32", device="cpu")

    # the CLI's lines, read as the J-mean tool reads them
    dataset_iou = res["dataset_iou"]
    per_seq = res["category_iou"]
    with open(os.path.join(out_root, "raw_fp32.log")) as fh:
        out = fh.read()
    assert dataset_iou == jmean.parse_avg_iou(out) and per_seq == jmean.parse_category_ious(out)
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
