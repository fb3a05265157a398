"""`evaluate_dataset` and the test_generator CLI of the port against the JAX
package's, on the CPU: synthetic DAVIS (raw mode), FBMS (annotated tuples,
host mode) and SegTrack (host mode) trees, float32, seeded random weights
at search range 2 with the generator's head scaled up (the sharp head of
chip_smoke.py) so the masks span [0, 1], batch 8, reader 64x128, working
32x64. The JAX side runs on the 8 virtual CPU devices of tests/conftest.py.
The CLI reads a TF1 bundle of the same weights as it reads the `.npz`.
"""

import importlib.util
import os
import re
import types

import numpy as np
import pytest
import torch

from synthetic import make_fbms_tree, make_moving_square_davis, make_segtrack_tree
from torch_parity import REPO, torch_threads
from unsupervised_detection_tpu.config import Config as JaxConfig
from unsupervised_detection_tpu.eval.evaluator import Evaluator as JaxEvaluator
from unsupervised_detection_tpu.eval.evaluator import evaluate_dataset as jax_evaluate_dataset
from unsupervised_detection_tpu_torch import Config
from unsupervised_detection_tpu_torch.convert import from_jax_params, random_jax_params
from unsupervised_detection_tpu_torch.eval import Evaluator, evaluate_dataset
from unsupervised_detection_tpu_torch.eval.evaluator import build_test_pipeline
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet
from unsupervised_detection_tpu_torch.test_generator import main
from unsupervised_detection_tpu_torch.train.checkpoint import (load_eval_checkpoint,
                                                               save_eval_checkpoint)
from unsupervised_detection_tpu_torch.train.tf1_export import export_tf1_checkpoint

_threads = torch_threads(2)

SIZES = dict(batch_size=8, reader_height=64, reader_width=128, img_height=32, img_width=64,
             pwc_search_range=2, num_threads=2)
# float32: conv sums in other orders move the soft mask by ~1e-5, which can
# flip a pixel lying that close to the 0.1 threshold: every IoU/MAE within
# 1e-3 (the tolerance of tests/test_torch_main_path.py).
TOL = 1e-3
CATEGORY = re.compile(r"^Category (\S+): IoU is (\S+) and MAE is (\S+)$", re.M)
NUMBER = re.compile(r"\d+(\.\d+)?(e-?\d+)?")


def _load_tool(name):
    path = os.path.join(REPO, "tools", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def weights():
    gen_p, gen_s, pwc_p = random_jax_params(GeneratorNet(), PWCNet(search_range=2), seed=6)
    gen_p["conv17"]["conv"]["kernel"] = gen_p["conv17"]["conv"]["kernel"] * 100.0
    return gen_p, gen_s, pwc_p


@pytest.fixture(scope="module")
def evaluators(weights):
    """One JAX evaluator (compiled once) and one port evaluator, both with
    the same weights, shared by every dataset."""
    jax_ev = JaxEvaluator(JaxConfig(**SIZES))
    state = types.SimpleNamespace(gen_params=weights[0], gen_stats=weights[1],
                                  pwc_params=weights[2])
    ev = Evaluator(Config(**SIZES), device="cpu")
    ev.load_state_dicts(*from_jax_params(*weights))
    return jax_ev, state, ev


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    mk = tmp_path_factory.mktemp
    return {
        "DAVIS2016": make_moving_square_davis(str(mk("davis")), frames=10, hw=(128, 192)),
        "FBMS": make_fbms_tree(str(mk("fbms"))),
        "SEGTRACK": make_segtrack_tree(str(mk("segtrack"))),
    }


def _record(monkeypatch, evaluator, frames):
    """Wrap evaluator.infer_metrics to keep each batch's (IoU, MAE) rows."""
    infer = evaluator.infer_metrics

    def recording(*args):
        out = infer(*args)
        frames.append(np.stack([np.asarray(out["iou"]), np.asarray(out["mae"])], axis=1))
        return out

    monkeypatch.setattr(evaluator, "infer_metrics", recording)


def _summary(out):
    """The summary lines with every number replaced: their format."""
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("Category ", "The Average", "Success", "Found "))]
    return [NUMBER.sub("N", ln) for ln in lines]


@pytest.mark.parametrize("dataset,partition,frames", [
    ("DAVIS2016", "trainval", 24),   # 20 samples: the last batch wraps, 4 counted twice
    ("FBMS", "val", 8),              # 6 annotated tuples in one wrapped batch
    ("SEGTRACK", "all", 16),         # 10 samples, the second batch wraps
])
def test_evaluate_dataset_matches_jax(dataset, partition, frames, trees, evaluators, capsys,
                                     monkeypatch):
    jax_ev, state, ev = evaluators
    per_frame = {"jax": [], "port": []}
    _record(monkeypatch, jax_ev, per_frame["jax"])
    _record(monkeypatch, ev, per_frame["port"])
    kw = dict(SIZES, dataset=dataset, root_dir=trees[dataset], test_partition=partition)
    want = jax_evaluate_dataset(JaxConfig(**kw), state, evaluator=jax_ev)
    want_out = capsys.readouterr().out
    got = evaluate_dataset(Config(**kw), ev)
    got_out = capsys.readouterr().out

    assert got["frames"] == want["frames"] == frames
    # per frame: random weights give small IoUs; the MAE (~0.2-0.3) carries
    # most of the signal
    got_f, want_f = np.concatenate(per_frame["port"]), np.concatenate(per_frame["jax"])
    assert got_f.shape == want_f.shape == (frames, 2)
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=TOL)
    # the JAX loop's bookkeeping: the wrapped duplicates count, in the frame
    # count and in their category; the dataset IoU is the frame sum over
    # them all, the sequence IoU the mean of the category means
    np.testing.assert_allclose(got["dataset_iou"], got_f[:, 0].astype(np.float64).mean(),
                               rtol=1e-12)
    np.testing.assert_allclose(got["sequence_iou"], np.mean(list(got["category_iou"].values())),
                               rtol=1e-12)
    # categories in the same (insertion) order, every IoU/MAE within TOL
    want_cats = CATEGORY.findall(want_out)
    got_cats = CATEGORY.findall(got_out)
    assert [c[0] for c in got_cats] == [c[0] for c in want_cats] == list(got["category_iou"])
    assert list(got["category_iou"]) == list(want["category_iou"])
    for (name, g_iou, g_mae), (_, w_iou, w_mae) in zip(got_cats, want_cats):
        assert abs(float(g_iou) - float(w_iou)) <= TOL, name
        assert abs(float(g_mae) - float(w_mae)) <= TOL, name
        assert float(g_iou) == got["category_iou"][name]
        assert float(g_mae) == got["category_mae"][name]
    for key in ("dataset_iou", "dataset_mae", "sequence_iou"):
        assert abs(got[key] - want[key]) <= TOL, key
    # the masks are not degenerate: the metrics see both classes
    assert 0.0 < want["dataset_mae"] < 1.0
    assert _summary(got_out) == _summary(want_out)


def test_visualization_needs_the_recover_net(evaluators, trees, tmp_path, capsys):
    # it does not: the dense path runs on the generator and PWC weights
    # alone (the recover net's flow enters no file) and writes a PNG and a
    # .mat per frame (one batch here; test_torch_ensemble.py holds the
    # whole path to JAX's and to the metrics-only path)
    _, _, ev = evaluators
    cfg = Config(**SIZES, root_dir=trees["DAVIS2016"])
    first = list(build_test_pipeline(cfg))[:1]
    dense = evaluate_dataset(cfg, ev, save_dir=str(tmp_path), generate_visualization=True,
                             verbose=False, batches=first)
    files = sorted(f for _, _, fs in os.walk(tmp_path) for f in fs)
    assert dense["frames"] == 8 and len(files) == 2 * 8
    assert sum(f.endswith(".png") for f in files) == sum(f.endswith(".mat") for f in files)
    # without a save dir the JAX loop takes the metrics path too; quiet
    # but for the reader's "Found ..." lines
    assert evaluate_dataset(cfg, ev, generate_visualization=True, verbose=False)["frames"] == 16
    out = capsys.readouterr().out
    assert _summary(out) == ["Found N images belonging to N experiments."] * 2


@pytest.fixture(scope="module")
def ckpt_file(weights, tmp_path_factory):
    return save_eval_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "random.npz"), *weights)


def _flags(root, ckpt, **extra):
    flags = {**SIZES, "root_dir": root, "ckpt_file": ckpt, **extra}
    return [f"--{k}={v}" for k, v in flags.items()]


def test_cli_prints_what_the_jmean_tool_parses(trees, ckpt_file, evaluators, capsys):
    res = main(_flags(trees["DAVIS2016"], ckpt_file), device="cpu")
    out = capsys.readouterr().out
    tool = _load_tool("exp_e2e_jmean")
    assert tool.parse_avg_iou(out) == pytest.approx(res["dataset_iou"], abs=1e-12)
    assert tool.parse_category_ious(out) == pytest.approx(res["category_iou"], abs=1e-12)
    assert "Resume model from checkpoint " + ckpt_file in out
    # the CLI's weights are the evaluator fixture's: the same numbers
    _, _, ev = evaluators
    cfg = Config(**SIZES, root_dir=trees["DAVIS2016"])
    assert evaluate_dataset(cfg, ev, verbose=False) == res


def test_cli_reads_a_tf1_bundle_as_the_npz(trees, ckpt_file, weights, tmp_path, capsys):
    # the same weights as a TF1 bundle (the reference's names, through the
    # port's writer): the same state dicts and the same metrics, bit for bit
    state = types.SimpleNamespace(generator=GeneratorNet(), recover=RecoverNet(),
                                  pwc=PWCNet(search_range=2), step=0)
    gen_sd, pwc_sd = from_jax_params(*weights)
    state.generator.load_state_dict(gen_sd)
    state.pwc.load_state_dict(pwc_sd)
    bundle = export_tf1_checkpoint(state, str(tmp_path / "model"))
    for got, want in zip(load_eval_checkpoint(bundle, 2), load_eval_checkpoint(ckpt_file, 2)):
        assert set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items())
    root = trees["DAVIS2016"]
    assert main(_flags(root, bundle), device="cpu") == main(_flags(root, ckpt_file), device="cpu")
    assert "Resume model from checkpoint " + bundle in capsys.readouterr().out


def test_cli_failures_match_the_jax_cli(trees, ckpt_file):
    jax_cli = _load_tool_root("test_generator")
    with pytest.raises(SystemExit) as want:
        jax_cli.main(["test_generator.py", "--bogus=1"])
    with pytest.raises(SystemExit) as got:
        main(["--bogus=1"], device="cpu")
    assert str(got.value) == str(want.value) == "Unknown flag: --bogus"
    root = trees["DAVIS2016"]
    with pytest.raises(OSError, match="^Checkpoint file not found$"):
        main(_flags(root, ""), device="cpu")
    with pytest.raises(OSError, match="^Checkpoint file not found$"):
        main(_flags(root, os.path.join(root, "missing.npz")), device="cpu")
    with pytest.raises(OSError, match="^Dataset should be DAVIS2016 / FBMS / SEGTRACK$"):
        main(_flags(root, ckpt_file, dataset="BOGUS"), device="cpu")
    with pytest.raises(ValueError, match="search range 2"):
        main(_flags(root, ckpt_file, pwc_search_range=4), device="cpu")


def _load_tool_root(name):
    spec = importlib.util.spec_from_file_location("jax_" + name, os.path.join(REPO, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
