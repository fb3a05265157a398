"""The port's dense evaluation (`Evaluator.infer`, `evaluate_dataset` with
`--generate_visualization`), its 4-crop `EnsembleEvaluator` and the CLI
chain test_generator_ensemble -> post_processing, against the JAX
package's on the CPU: float32, batch 4, reader 64x128, working 32x64, PWC
r=2. Seeded random weights (the generator's head scaled up so the masks
span [0, 1]) except in the chain, which runs the committed flagship
checkpoints. The JAX side runs one `Evaluator` and one `EnsembleEvaluator`,
each compiled once."""

import importlib.util
import os
import re
import types

import numpy as np
import pytest
import scipy.io as sio

from synthetic import make_moving_square_davis
from torch_parity import REPO, committed_checkpoints, moving_square_frames, torch_threads
from unsupervised_detection_tpu.config import Config as JaxConfig
from unsupervised_detection_tpu.eval.ensemble import EnsembleEvaluator as JaxEnsembleEvaluator
from unsupervised_detection_tpu.eval.evaluator import Evaluator as JaxEvaluator
from unsupervised_detection_tpu.eval.evaluator import evaluate_dataset as jax_evaluate_dataset
from unsupervised_detection_tpu.postproc import buffer_to_soft_score as jax_soft_score
from unsupervised_detection_tpu.postproc import run_crf as jax_run_crf
from unsupervised_detection_tpu_torch import Config, post_processing, test_generator
from unsupervised_detection_tpu_torch import test_generator_ensemble
from unsupervised_detection_tpu_torch.convert import (from_jax_params, random_jax_params,
                                                      random_recover_params)
from unsupervised_detection_tpu_torch.eval import (TEST_CROPS, EnsembleEvaluator, Evaluator,
                                                   evaluate_dataset)
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet
from unsupervised_detection_tpu_torch.train import checkpoint

SIZES = dict(batch_size=4, reader_height=64, reader_width=128, img_height=32, img_width=64,
             pwc_search_range=2, num_threads=2)
# float32, conv sums in other orders (oneDNN vs XLA): masks within 1e-4,
# the flows within 1e-4 of their largest component; the resizes of the
# inputs are matrix products of the same float32 matrices: 1e-6.
MASK_TOL, FLOW_REL, INPUT_TOL = 1e-4, 1e-4, 1e-6
# the crop-1.0 member and the port's Evaluator.infer: the same function of
# the same inputs, batched 4x larger (oneDNN may block the convolutions
# differently)
MEMBER_TOL = 1e-5
# the metrics of the dense path (numpy on the host) and the metrics-only
# path (reduced on the device) count the same pixels
METRIC_TOL = 1e-6
# the chain: a mask within MASK_TOL of JAX's can binarize differently
# where it sits at the 0.1 threshold, and one pixel moves a soft score by
# up to a sixteenth; Farneback and the CRF then see the scores
SOFT_MAX, SOFT_MEAN, CRF_IOU_TOL = 1e-2, 1e-4, 5e-3
CATEGORY = re.compile(r"^Category (\S+): IoU is (\S+) and MAE is (\S+)$", re.M)
NUMBER = re.compile(r"\d+(\.\d+)?(e-?\d+)?")


_threads = torch_threads(2)


@pytest.fixture(scope="module")
def weights():
    gen_p, gen_s, pwc_p = random_jax_params(GeneratorNet(), PWCNet(search_range=2), seed=6)
    gen_p["conv17"]["conv"]["kernel"] = gen_p["conv17"]["conv"]["kernel"] * 100.0
    return gen_p, gen_s, pwc_p, random_recover_params(RecoverNet(), seed=2)


@pytest.fixture(scope="module")
def jax_side(weights):
    """One JAX Evaluator and one JAX EnsembleEvaluator for the whole file,
    and the random weights as a JAX state."""
    cfg = JaxConfig(**SIZES)
    state = types.SimpleNamespace(gen_params=weights[0], gen_stats=weights[1],
                                  pwc_params=weights[2], rec_params=weights[3])
    return JaxEvaluator(cfg), JaxEnsembleEvaluator(cfg), state


@pytest.fixture(scope="module")
def ckpt(weights, tmp_path_factory):
    """The generator and PWC weights as an evaluation checkpoint."""
    d = tmp_path_factory.mktemp("ckpts")
    return checkpoint.save_eval_checkpoint(str(d / "a.npz"), *weights[:3])


def _port_evaluator(weights, cls=Evaluator, **kw):
    ev = cls(Config(**{**SIZES, **kw}), device="cpu")
    ev.load_state_dicts(*from_jax_params(*weights[:3]))
    return ev


@pytest.fixture(scope="module")
def port_ev(weights):
    """One port Evaluator at SIZES for the file."""
    return _port_evaluator(weights)


def _batch(seed=0):
    img1, img2, gt = moving_square_frames(SIZES["batch_size"], 64, 128, seed=seed)
    return {"img1": img1, "img2": img2, "gt": gt}


def test_infer_matches_jax(port_ev, jax_side):
    jax_ev, _, state = jax_side
    batch = _batch()
    want = jax_ev.infer(state.gen_params, state.gen_stats, state.rec_params, state.pwc_params,
                        *jax_ev.device_batch(batch))
    got = {k: v.numpy() for k, v in port_ev.infer(*port_ev.device_batch(batch)).items()}
    # JAX's infer also returns the recover net's flow, which nothing reads
    assert sorted(got) == sorted(k for k in want if k != "pred_flow")
    for k in got:
        v = np.asarray(want[k])
        assert got[k].shape == v.shape and got[k].dtype == np.float32, k
        if k == "gt_flow":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=FLOW_REL * np.abs(v).max(),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=0,
                                       atol=MASK_TOL if k == "gen_masks" else INPUT_TOL,
                                       err_msg=k)
    assert 0.0 < got["gen_masks"].min() < 0.1 and got["gen_masks"].max() > 0.9


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                  for f in fs)


def test_dense_evaluation_matches_jax(ckpt, port_ev, jax_side, tmp_path, capsys):
    # 10 samples in 3 batches, the last wrapped: 12 frames, 6 per category
    jax_ev, _, state = jax_side
    root = make_moving_square_davis(str(tmp_path / "davis"), frames=5, hw=(128, 192))
    kw = dict(SIZES, root_dir=root, test_partition="trainval")
    want = jax_evaluate_dataset(JaxConfig(**kw), state, save_dir=str(tmp_path / "jax"),
                                generate_visualization=True, evaluator=jax_ev, verbose=False)
    flags = [f"--{k}={v}" for k, v in kw.items()] + [f"--ckpt_file={ckpt}"]
    got = test_generator.main(flags + ["--generate_visualization",
                                       f"--test_save_dir={tmp_path / 'port'}"], device="cpu")
    metrics_only = evaluate_dataset(Config(**kw), port_ev, verbose=False)
    capsys.readouterr()

    assert got["frames"] == want["frames"] == metrics_only["frames"] == 12
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port") and len(files) == 2 * 12
    for rel in files:
        if rel.endswith(".png"):
            import cv2

            assert cv2.imread(str(tmp_path / "port" / rel)).shape == (384, 640, 3)
            continue
        g, w = sio.loadmat(str(tmp_path / "port" / rel)), sio.loadmat(str(tmp_path / "jax" / rel))
        keys = sorted(k for k in w if not k.startswith("__"))
        assert keys == sorted(k for k in g if not k.startswith("__")) == [
            "flow", "gt_mask", "img1", "pred_mask"]
        for k in keys:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, (rel, k)
        np.testing.assert_array_equal(g["pred_mask"], w["pred_mask"], err_msg=rel)
        np.testing.assert_allclose(g["gt_mask"], w["gt_mask"], rtol=0, atol=INPUT_TOL)
        np.testing.assert_allclose(g["img1"], w["img1"], rtol=0, atol=INPUT_TOL)
        np.testing.assert_allclose(g["flow"], w["flow"], rtol=0,
                                   atol=FLOW_REL * np.abs(w["flow"]).max())
    for key in ("category_iou", "category_mae"):
        for cat, v in metrics_only[key].items():
            assert abs(got[key][cat] - v) <= METRIC_TOL, (key, cat)
    for key in ("dataset_iou", "dataset_mae", "sequence_iou"):
        assert abs(got[key] - metrics_only[key]) <= METRIC_TOL, key
        assert abs(got[key] - want[key]) <= METRIC_TOL, key
    assert list(got["category_iou"]) == list(want["category_iou"])


def test_ensemble_matches_jax(weights, jax_side):
    _, jax_ens, state = jax_side
    batch = _batch(seed=2)
    want = jax_ens.run(state, batch)
    # the port's ensemble ignores config.test_crop, as JAX's does (JAX's
    # runs at the default 0.9)
    ens = _port_evaluator(weights, EnsembleEvaluator, test_crop=0.5)
    got = ens.run(batch)
    n = len(TEST_CROPS)
    b = SIZES["batch_size"]
    for k, shape in (("pred_masks", (n, b, 32, 64, 1)), ("gt_masks", (n, b, 32, 64, 1)),
                     ("img_1s", (n, b, 32, 64, 3))):
        assert got[k].shape == np.asarray(want[k]).shape == shape
        assert got[k].dtype == np.float32
        tol = MASK_TOL if k == "pred_masks" else INPUT_TOL
        for ci in range(n):
            np.testing.assert_allclose(got[k][ci], np.asarray(want[k][ci]), rtol=0, atol=tol,
                                       err_msg=f"{k} crop {TEST_CROPS[ci]}")
    assert not np.allclose(got["pred_masks"][0], got["pred_masks"][3])
    # the gt is cropped bilinearly: fractional at the square's edge
    assert np.any((got["gt_masks"] > 0) & (got["gt_masks"] < 1))
    # the crop-1.0 member is the plain path at test_crop=1.0
    ev = _port_evaluator(weights, test_crop=1.0)
    plain = ev.infer(*ev.device_batch(batch))
    full = TEST_CROPS.index(1.0)
    np.testing.assert_allclose(got["pred_masks"][full], plain["gen_masks"].numpy(), rtol=0,
                               atol=MEMBER_TOL)
    np.testing.assert_array_equal(got["gt_masks"][full], plain["gt_masks"].numpy())


def _load_root_cli(name):
    spec = importlib.util.spec_from_file_location("jax_" + name, os.path.join(REPO, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _summary(out):
    lines = [ln for ln in out.splitlines() if ln.startswith(("Category ", "The Average",
                                                             "Success"))]
    return [NUMBER.sub("N", ln) for ln in lines]


def test_cli_chain_matches_jax(jax_side, tmp_path, monkeypatch, capsys):
    """The port's ensemble CLI for the shifts -2, -1, 1, 2 and its
    post_processing CLI (Farneback propagation, the native CRF) against the
    JAX CLI's loop and the JAX library on the same tree and flagship
    weights."""
    import unsupervised_detection_tpu.eval.ensemble as jax_ensemble_mod
    import unsupervised_detection_tpu.train as jax_train
    from unsupervised_detection_tpu.train import checkpoint as jax_ckpt

    _, jax_ens, _ = jax_side
    gen_p, gen_s, pwc_p = committed_checkpoints()
    flagship = types.SimpleNamespace(gen_params=gen_p, gen_stats=gen_s, pwc_params=pwc_p)
    ckpt = checkpoint.save_eval_checkpoint(str(tmp_path / "flagship.npz"), gen_p, gen_s, pwc_p)

    # the JAX CLI's own loop, with the file's evaluator and the flagship state
    monkeypatch.setattr(jax_train, "AdversarialLearner", lambda cfg: types.SimpleNamespace(
        init_state=lambda key: flagship))
    monkeypatch.setattr(jax_ckpt, "restore_checkpoint", lambda path, state: state)
    monkeypatch.setattr(jax_ensemble_mod, "EnsembleEvaluator", lambda cfg: jax_ens)
    jax_cli = _load_root_cli("test_generator_ensemble")

    # 2 x 4 frames, two full batches: a wrapped last batch would number its
    # duplicates differently under each shift's sample order, and the soft
    # score needs the same frames under every shift
    root = make_moving_square_davis(str(tmp_path / "davis"), frames=4, hw=(128, 192))
    kw = dict(SIZES, root_dir=root, test_partition="trainval", ckpt_file=ckpt)
    outs = {}
    for s in (-2, -1, 1, 2):
        extra = dict(test_temporal_shift=s, generate_visualization=True)
        jax_cli._test_masks(JaxConfig(**kw, **extra,
                                      test_save_dir=str(tmp_path / "jbuf" / f"davis_shift_{s}")))
        want_out = capsys.readouterr().out
        res = test_generator_ensemble.main(
            [f"--{k}={v}" for k, v in kw.items()] + [
                f"--test_temporal_shift={s}", "--generate_visualization",
                f"--test_save_dir={tmp_path / 'tbuf' / f'davis_shift_{s}'}"], device="cpu")
        got_out = capsys.readouterr().out
        assert _summary(got_out) == _summary(want_out)
        assert res["frames"] == 8
        for (name, g_iou, g_mae), (w_name, w_iou, w_mae) in zip(CATEGORY.findall(got_out),
                                                                 CATEGORY.findall(want_out)):
            assert name == w_name
            assert abs(float(g_iou) - float(w_iou)) <= 1e-3
            assert abs(float(g_mae) - float(w_mae)) <= 1e-3
        outs[s] = res
    assert _files(tmp_path / "jbuf") == _files(tmp_path / "tbuf")
    m = sio.loadmat(str(tmp_path / "tbuf" / "davis_shift_1" / "seq_a" / "result_1.mat"))
    assert sorted(k for k in m if not k.startswith("__")) == sorted(
        f"{p}_{c:03d}" for p in ("img_1", "pred_mask", "gt_mask") for c in (85, 90, 95, 100))

    names, nums = ["seq_a", "seq_b"], [len(os.listdir(tmp_path / "jbuf" / "davis_shift_1" / s))
                                       for s in ("seq_a", "seq_b")]
    got = post_processing.main([f"--path_buffer={tmp_path / 'tbuf'}",
                                f"--out_soft_score={tmp_path / 'tsoft'}",
                                f"--resized_out={tmp_path / 'tcrf'}",
                                "--flow_backend=farneback", "--discover_sequences"])
    out = capsys.readouterr().out
    assert "Propagation flow backend: farneback" in out and "iou of the resized version:" in out
    assert got["iou_original"] is None
    # the JAX library on the port's buffers: the same bits
    jax_soft_score(str(tmp_path / "tbuf"), str(tmp_path / "jsoft_t"), seq_names=names,
                   seq_num=nums, flow_fn="farneback")
    assert jax_run_crf(str(tmp_path / "jsoft_t"), 25.0, 5.0, 5.0, 0.1,
                       out_path=str(tmp_path / "jcrf_t")) == got["iou_resized"]
    _assert_mat_trees_equal(tmp_path / "tsoft", tmp_path / "jsoft_t")
    _assert_mat_trees_equal(tmp_path / "tcrf", tmp_path / "jcrf_t")

    # the JAX library on the JAX CLI's buffers
    jax_soft_score(str(tmp_path / "jbuf"), str(tmp_path / "jsoft"), seq_names=names,
                   seq_num=nums, flow_fn="farneback")
    want_iou = jax_run_crf(str(tmp_path / "jsoft"), 25.0, 5.0, 5.0, 0.1,
                           out_path=str(tmp_path / "jcrf"))
    assert _files(tmp_path / "jsoft") == _files(tmp_path / "tsoft")
    for rel in _files(tmp_path / "jsoft"):
        g = sio.loadmat(str(tmp_path / "tsoft" / rel))
        w = sio.loadmat(str(tmp_path / "jsoft" / rel))
        d = np.abs(g["pred_mask"] - w["pred_mask"])
        assert d.max() <= SOFT_MAX and d.mean() <= SOFT_MEAN, (rel, d.max(), d.mean())
        # The running averages are not held here: their Farneback inputs,
        # img1 as uint8, differ by one level at pixels where the two
        # buffers' images differ by one float32 ulp (XLA's CPU code
        # computes the feeder's x / 255 - 0.5 as one fused multiply-add).
        # The bit-equal run above holds the propagation on equal inputs.
    assert abs(got["iou_resized"] - want_iou) <= CRF_IOU_TOL
    assert 0.0 < want_iou < 1.0


def _assert_mat_trees_equal(got_root, want_root):
    assert _files(got_root) == _files(want_root)
    for rel in _files(want_root):
        g, w = sio.loadmat(os.path.join(got_root, rel)), sio.loadmat(os.path.join(want_root, rel))
        keys = sorted(k for k in w if not k.startswith("__"))
        assert sorted(k for k in g if not k.startswith("__")) == keys
        for k in keys:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{rel} {k}")


def test_post_processing_cli_refusals(tmp_path):
    with pytest.raises(SystemExit, match="requires --flow_ckpt"):
        post_processing.main(["--flow_backend=pwc"], device="cpu")
    with pytest.raises(SystemExit):
        post_processing.main(["--flow_backend=bogus"])
