"""The port's post-processing (postproc/, native/) against the JAX
package's, on the CPU: the host copies (permutohedral lattice, dense CRF in
both engines, soft scores, host propagation, the native pyflow solver) give
the same bits on the same inputs and one shared buffer tree; `pwc_flow_fn`
agrees within the stated limit, and gives the same bits from a TF1 bundle
of the same weights."""

import os

import numpy as np
import pytest
import scipy.io as sio

from torch_parity import PWC_CKPT, PWC_CKPT_SEARCH_RANGE, REPO, torch_threads
from unsupervised_detection_tpu.postproc import crf as jcrf
from unsupervised_detection_tpu.postproc import permutohedral as jperm
from unsupervised_detection_tpu.postproc import propagate as jprop
from unsupervised_detection_tpu.postproc import soft_score as jsoft
from unsupervised_detection_tpu_torch.models import PWCNet
from unsupervised_detection_tpu_torch.native import densecrf as tdensecrf
from unsupervised_detection_tpu_torch.native import pyflow as tpyflow
from unsupervised_detection_tpu_torch.postproc import crf as tcrf
from unsupervised_detection_tpu_torch.postproc import permutohedral as tperm
from unsupervised_detection_tpu_torch.postproc import propagate as tprop
from unsupervised_detection_tpu_torch.postproc import soft_score as tsoft
from unsupervised_detection_tpu_torch.train.checkpoint import restore_params_scope
from unsupervised_detection_tpu_torch.train.tf1_bundle import write_bundle
from unsupervised_detection_tpu_torch.train.tf1_export import tf1_tensors

# pwc_flow_fn: float32 convolutions in other libraries (oneDNN vs XLA)
# through 5 levels: within 1e-4 of the flow's largest component.
PWC_FLOW_REL = 1e-4
SEQS = (("seq_a", 4), ("seq_b", 3))
HW = (32, 64)
SHIFTS = (-2, -1, 1, 2)
CROPS = (85, 90, 95, 100)


_threads = torch_threads(2)


def _texture(rs, shape):
    t = rs.rand(*shape).astype(np.float32)
    for axis in (0, 1):
        t = (t + np.roll(t, 1, axis) + np.roll(t, -1, axis)) / 3.0
    return t


def _write_buffer_tree(root, seed=0):
    """A buffer tree in the ensemble CLI's layout (davis_shift_<s>/<seq>/
    result_<k>.mat with img_1_XXX, pred_mask_XXX, gt_mask_XXX per crop): a
    textured square moving over a textured background, binary masks with
    noise, and in some members a mask that fills the border (the soft
    score's sanity check drops those)."""
    rs = np.random.RandomState(seed)
    h, w = HW
    for seq, frames in SEQS:
        bg = _texture(rs, (h, w, 3))
        fg = _texture(rs, (10, 14, 3))
        for k in range(1, frames + 1):
            y, x = 8 + k, 12 + 3 * k
            img = bg.copy()
            img[y:y + 10, x:x + 14] = fg
            gt = np.zeros((h, w, 1), np.float32)
            gt[y:y + 10, x:x + 14] = 1.0
            for s in SHIFTS:
                out = {}
                for c in CROPS:
                    mask = gt.astype(np.float64).copy()
                    mask[rs.rand(h, w, 1) < 0.03] = 1.0
                    if rs.rand() < 0.15:
                        mask = 1.0 - mask
                    out["img_1_%03d" % c] = img - 0.5
                    out["pred_mask_%03d" % c] = mask
                    out["gt_mask_%03d" % c] = gt
                d = os.path.join(root, "davis_shift_%d" % s, seq)
                os.makedirs(d, exist_ok=True)
                sio.savemat(os.path.join(d, "result_%d.mat" % k), out)
    return root


def _assert_mat_trees_equal(got_root, want_root):
    files = sorted(os.path.relpath(os.path.join(d, f), want_root)
                   for d, _, fs in os.walk(want_root) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), got_root)
                           for d, _, fs in os.walk(got_root) for f in fs)
    assert files
    for rel in files:
        got = sio.loadmat(os.path.join(got_root, rel))
        want = sio.loadmat(os.path.join(want_root, rel))
        keys = sorted(k for k in want if not k.startswith("__"))
        assert sorted(k for k in got if not k.startswith("__")) == keys, rel
        for k in keys:
            assert got[k].dtype == want[k].dtype, (rel, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{rel} {k}")


@pytest.fixture(scope="module")
def soft_trees(tmp_path_factory):
    """The buffer tree ensembled by the JAX package and by the port, each
    with its own Farneback propagation."""
    root = tmp_path_factory.mktemp("postproc")
    buf = _write_buffer_tree(str(root / "buffer"))
    names, nums = [s for s, _ in SEQS], [n for _, n in SEQS]
    out = {}
    for side, module in (("jax", jsoft), ("port", tsoft)):
        out[side] = str(root / ("soft_" + side))
        module.buffer_to_soft_score(buf, out[side], seq_names=names, seq_num=nums,
                                    flow_fn="farneback")
    return out


def test_soft_score_and_propagation_bit_equal(soft_trees):
    _assert_mat_trees_equal(soft_trees["port"], soft_trees["jax"])
    m = sio.loadmat(os.path.join(soft_trees["port"], "seq_a", "result_2.mat"))
    assert m["pred_mask"].shape == HW and m["running_avg_f"].shape == HW
    assert 0.0 <= m["pred_mask"].min() and m["pred_mask"].max() <= 1.0


def test_run_crf_native_bit_equal(soft_trees, tmp_path):
    # backend "auto" on both sides: the native solvers, built from the same
    # source with the same flags
    assert tcrf.backend_name() == "native"
    want = jcrf.run_crf(soft_trees["jax"], 25.0, 5.0, 5.0, 0.1, out_path=str(tmp_path / "j"))
    got = tcrf.run_crf(soft_trees["port"], 25.0, 5.0, 5.0, 0.1, out_path=str(tmp_path / "t"))
    assert got == want and 0.0 < got <= 1.0
    _assert_mat_trees_equal(str(tmp_path / "t"), str(tmp_path / "j"))


def _crf_inputs(h=24, w=32, seed=7):
    rs = np.random.RandomState(seed)
    image = (rs.rand(h, w, 3) * 255).astype(np.uint8)
    image[:, : w // 2] = (240, 40, 40)
    p = np.clip(rs.rand(h, w), 1e-6, 1 - 1e-6)
    return -np.log(np.stack([1 - p, p])).astype(np.float32), image


def test_dense_crf_numpy_engine_bit_equal():
    unary, image = _crf_inputs()
    want = jcrf.dense_crf_binary(unary, image, 8.0, 5.0, 3.0, n_iterations=5, backend="numpy")
    got = tcrf.dense_crf_binary(unary, image, 8.0, 5.0, 3.0, n_iterations=5, backend="numpy")
    np.testing.assert_array_equal(got, want)


def test_dense_crf_native_bit_equal():
    from unsupervised_detection_tpu.native import densecrf as jdensecrf

    unary, image = _crf_inputs(seed=8)
    want = jdensecrf.dense_crf_binary(unary, image, 8.0, 5.0, 3.0, n_iterations=10)
    got = tcrf.dense_crf_binary(unary, image, 8.0, 5.0, 3.0, n_iterations=10, backend="native")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdensecrf.dense_crf_binary(unary, image, 8.0, 5.0, 3.0, 10), want)
    # the library lives in the port's build directory, not under native/
    assert os.path.dirname(tdensecrf.library()._name) == os.path.join(
        REPO, "unsupervised_detection_tpu_torch", "build")


def test_native_backend_rule_when_the_build_fails(monkeypatch, capsys):
    def broken(*_):
        raise RuntimeError("g++ failed")

    caches = (tdensecrf.library, tcrf._native_build, tcrf._warn_numpy_engine)
    for cache in caches:
        cache.cache_clear()
    monkeypatch.setattr(tdensecrf, "load_library", broken)
    try:
        unary, image = _crf_inputs(seed=9)
        with pytest.raises(RuntimeError, match="native dense-CRF backend requested"):
            tcrf.dense_crf_binary(unary, image, 8.0, 5.0, 3.0, n_iterations=3, backend="native")
        assert tcrf.backend_name() == "numpy"
        got = tcrf.dense_crf_binary(unary, image, 8.0, 5.0, 3.0, n_iterations=3)
        want = tcrf.dense_crf_binary(unary, image, 8.0, 5.0, 3.0, n_iterations=3,
                                     backend="numpy")
        np.testing.assert_array_equal(got, want)
        assert capsys.readouterr().out.count("WARNING: native dense-CRF unavailable") == 1
    finally:
        monkeypatch.undo()
        for cache in caches:
            cache.cache_clear()


@pytest.mark.parametrize("reverse", [False, True])
def test_permutohedral_bit_equal(reverse):
    rs = np.random.RandomState(11)
    feats = rs.rand(300, 5) * 4.0
    values = rs.rand(300, 2)
    got = tperm.PermutohedralLattice(feats).compute(values, reverse=reverse)
    want = jperm.PermutohedralLattice(feats).compute(values, reverse=reverse)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ratio", [85 / 90.0, 95 / 90.0, 100 / 90.0, 1.0])
def test_rectify_pred_mask_bit_equal(ratio):
    m = np.random.RandomState(3).rand(*HW)
    np.testing.assert_array_equal(tsoft.rectify_pred_mask(m, ratio, *HW),
                                  jsoft.rectify_pred_mask(m, ratio, *HW))
    assert tsoft.sanity_check(m) == jsoft.sanity_check(m)


def test_refine_and_select_candidate_bit_equal():
    rs = np.random.RandomState(12)
    image = (rs.rand(*HW, 3) * 255).astype(np.uint8)
    masks = [rs.rand(*HW) for _ in range(3)]
    gt = (masks[0] > 0.6).astype(np.float32)
    pick = tcrf.select_candidate(*masks, gt)
    assert pick is masks[[m is jcrf.select_candidate(*masks, gt) for m in masks].index(True)]
    got = tcrf.refine_mask(pick, image, 0.1, 25.0, 5.0, 5.0, gt)
    want = jcrf.refine_mask(pick, image, 0.1, 25.0, 5.0, 5.0, gt)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_pyflow_native_bit_equal():
    from unsupervised_detection_tpu.native import pyflow as jpyflow

    rs = np.random.RandomState(13)
    big = _texture(rs, (40, 56, 3)).astype(np.float64)
    im1, im2 = big[4:36, 4:52], big[3:35, 6:54]
    got, want = tpyflow.coarse2fine_flow(im1, im2), jpyflow.coarse2fine_flow(im1, im2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tprop.pyflow_flow(im1, im2)[0], jprop.pyflow_flow(im1, im2)[0])


@pytest.mark.parametrize("n,pad", [(48, 16), (80, 48), (32, 32), (5, 13), (2, 3)])
def test_reflect_index_is_numpys_reflect(n, pad):
    a = np.arange(n)
    np.testing.assert_array_equal(a[tprop._reflect_index(n, pad)],
                                  np.pad(a, (0, pad), mode="reflect"))


@pytest.fixture(scope="module")
def pwc_scope_save(tmp_path_factory):
    """The committed PWC checkpoint (r=2) exported as a port scope save."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", os.path.join(REPO, "tools", "export_torch_checkpoint.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.export_scope(str(tmp_path_factory.mktemp("pwc") / "pwc.npz"), PWC_CKPT,
                             "pwc_params")


def test_pwc_flow_fn_matches_jax(pwc_scope_save):
    # 48x80 is not a multiple of 64: the reflect pad (16 rows, 48 columns)
    # and the crop back
    rs = np.random.RandomState(0)
    big = _texture(rs, (56, 88, 3)).astype(np.float64)
    im_a, im_b = big[4:52, 4:84], big[2:50, 7:87]
    want = jprop.pwc_flow_fn(PWC_CKPT, search_range=PWC_CKPT_SEARCH_RANGE)(im_a, im_b)
    flow_fn = tprop.pwc_flow_fn(pwc_scope_save, search_range=PWC_CKPT_SEARCH_RANGE,
                                device="cpu")
    got = flow_fn(im_a, im_b)
    top = max(np.abs(w).max() for w in want)
    assert top > 0.5
    for g, w in zip(got, want):
        assert g.shape == w.shape == (48, 80) and g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0, atol=PWC_FLOW_REL * top)
    # drives the host propagation as the JAX backend does
    masks = [np.zeros((48, 80)) for _ in range(3)]
    for m in masks:
        m[10:20, 20:40] = 1.0
    avgs = tprop.propagate_masks(masks, [im_a, im_b, im_a], flow_fn=flow_fn)
    assert len(avgs) == 3 and all(np.isfinite(a).all() for a in avgs)


def test_pwc_flow_fn_refuses_tf1_and_other_ranges(pwc_scope_save, tmp_path):
    # a TF1 bundle of the same weights gives the same flow, bit for bit;
    # either checkpoint at another search range is refused, naming both
    net = PWCNet(search_range=PWC_CKPT_SEARCH_RANGE)
    restore_params_scope(pwc_scope_save, net, "pwc_params")
    tf1 = write_bundle(str(tmp_path / "model"), tf1_tensors(net))
    rs = np.random.RandomState(1)
    im_a, im_b = _texture(rs, (40, 72, 3)), _texture(rs, (40, 72, 3))
    want = tprop.pwc_flow_fn(pwc_scope_save, search_range=2, device="cpu")(im_a, im_b)
    got = tprop.pwc_flow_fn(tf1, search_range=2, device="cpu")(im_a, im_b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for ckpt in (tf1, pwc_scope_save):
        with pytest.raises(ValueError, match="search range 2, but --pwc_search_range=4"):
            tprop.pwc_flow_fn(ckpt, search_range=4, device="cpu")
