"""The port's TF1 checkpoints (train/tf1_bundle.py, tf1_import.py,
tf1_export.py) against TensorFlow and the JAX package, on the CPU: the
name maps equal JAX's; a bundle that JAX writes through TensorFlow, with
Adam slots added, restores bit-equal to convert.py's state dicts; a bundle
the port writes reads bit-equal through `tf.train.load_checkpoint` and
JAX's `restore_tf1_full`; the reader equals TF's `get_tensor`; the C crc32c
equals the plain one; and damaged or foreign bundles are refused, naming
the variable. The flax trees are seeded random (convert.random_jax_params),
at full width, PWC r=2: no JAX learner is built and nothing is compiled."""

import dataclasses
import os
import struct
import types

import numpy as np
import pytest
import torch

from torch_parity import torch_threads
from unsupervised_detection_tpu.train import tf1_export as jax_export
from unsupervised_detection_tpu.train import tf1_import as jax_import
from unsupervised_detection_tpu_torch.convert import (_leaves, from_jax_params,
                                                      random_jax_params, random_recover_params,
                                                      recover_state_dict)
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet
from unsupervised_detection_tpu_torch.native.crc32c import crc32c, crc32c_plain, mask
from unsupervised_detection_tpu_torch.train import tf1_bundle, tf1_export, tf1_import

tf = pytest.importorskip("tensorflow")

_threads = torch_threads(2)

STEP = 11
TREE_FIELDS = ("gen_params", "gen_stats", "rec_params", "pwc_params")


@dataclasses.dataclass(frozen=True)
class Trees:
    """The fields of a JAX TrainState that the JAX package's TF1 import and
    export read, as nested dicts of numpy arrays."""
    gen_params: dict
    gen_stats: dict
    rec_params: dict
    pwc_params: dict
    step: np.ndarray

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _trees(search_range, seed=0):
    gen_p, gen_s, pwc_p = random_jax_params(GeneratorNet(), PWCNet(search_range=search_range),
                                            seed)
    return Trees(gen_p, gen_s, random_recover_params(RecoverNet(), seed + 1), pwc_p,
                 np.int32(STEP))


def _port_state(search_range=2, step=0):
    return types.SimpleNamespace(generator=GeneratorNet(), recover=RecoverNet(),
                                 pwc=PWCNet(search_range=search_range), step=step)


def _load(state, trees):
    gen_sd, pwc_sd = from_jax_params(trees.gen_params, trees.gen_stats, trees.pwc_params)
    state.generator.load_state_dict(gen_sd)
    state.pwc.load_state_dict(pwc_sd)
    state.recover.load_state_dict(recover_state_dict(trees.rec_params))
    return state


def _assert_state_equal(state, trees):
    gen_sd, pwc_sd = from_jax_params(trees.gen_params, trees.gen_stats, trees.pwc_params)
    for net, want in ((state.generator, gen_sd), (state.pwc, pwc_sd),
                      (state.recover, recover_state_dict(trees.rec_params))):
        got = net.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def trees():
    return _trees(2)


@pytest.fixture(scope="module")
def jax_bundle(trees, tmp_path_factory):
    """JAX's export through TensorFlow, then a TF Saver's resave of it with
    Adam slots and beta1_power added, as a training save holds them."""
    tf1 = tf.compat.v1
    prefix = jax_export.export_tf1_checkpoint(
        trees, str(tmp_path_factory.mktemp("jax") / "model"))
    reader = tf.train.load_checkpoint(prefix)
    names = sorted(reader.get_variable_to_shape_map())
    slotted = ([n for n in names if n.startswith("MaskNet//conv1/")]
               + [n for n in names if n.startswith("FlownetS//")][:2])
    graph = tf1.Graph()
    with graph.as_default():
        feeds, tf_vars = {}, []
        for name, value in [(n, reader.get_tensor(n)) for n in names] + \
                [(f"{n}/Adam{s}", reader.get_tensor(n) * 0.5) for n in slotted for s in ("", "_1")] + \
                [("beta1_power", np.float32(0.9))]:
            init = tf1.placeholder(tf.as_dtype(value.dtype), np.shape(value))
            tf_vars.append(tf1.get_variable(name, initializer=init))
            feeds[init] = value
        saver = tf1.train.Saver(var_list=tf_vars)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer(), feed_dict=feeds)
            out = saver.save(sess, str(tmp_path_factory.mktemp("adam") / "model"),
                             write_meta_graph=False)
    return out, len(slotted)


@pytest.fixture(scope="module")
def port_bundle(trees, tmp_path_factory):
    """The port's export of the same weights, and its tensors by name."""
    state = _load(_port_state(step=STEP), trees)
    tensors = {}
    for net in (state.generator, state.recover, state.pwc):
        tensors.update(tf1_export.tf1_tensors(net))
    tensors["global_step"] = np.int64(STEP)
    prefix = tf1_export.export_tf1_checkpoint(state, str(tmp_path_factory.mktemp("port") /
                                                         "model"))
    return prefix, tensors


@pytest.mark.parametrize("search_range", [2, 4])
def test_name_maps_match_jax(search_range):
    t = _trees(search_range)
    jax_maps = {"gen": jax_import.generator_name_map(t.gen_params, t.gen_stats),
                "rec": jax_import.recover_name_map(t.rec_params),
                "pwc": jax_import.pwc_name_map(t.pwc_params)}
    nets = {"gen": GeneratorNet(), "rec": RecoverNet(), "pwc": PWCNet(search_range=search_range)}
    leaves = {"gen": list(_leaves(t.gen_params)) + list(_leaves(t.gen_stats)),
              "rec": list(_leaves(t.rec_params)), "pwc": list(_leaves(t.pwc_params))}
    for key, net in nets.items():
        port_map = tf1_import.name_map(net)
        paths = {path for path, _ in leaves[key]}
        assert set(port_map) == paths
        assert {p: port_map[p] for p in paths} == {p: jax_maps[key][p] for p in paths}
    assert len(set(tf1_import.name_map(nets["gen"]).values())) == 102


def test_jax_bundle_restores_bit_equal(trees, jax_bundle):
    prefix, n_slotted = jax_bundle
    assert n_slotted == 4      # a kernel and a bias of each net, two slots each
    state = tf1_import.restore_tf1_full(prefix, _port_state())
    _assert_state_equal(state, trees)
    assert state.step == STEP
    # one scope at a time leaves the others as they were
    fresh = _port_state()
    before = {k: v.clone() for k, v in fresh.generator.state_dict().items()}
    tf1_import.restore_tf1_scope(prefix, fresh, "pwc")
    assert all(torch.equal(fresh.generator.state_dict()[k], v) for k, v in before.items())
    assert fresh.step == 0
    _, pwc_sd = from_jax_params(trees.gen_params, trees.gen_stats, trees.pwc_params)
    assert all(torch.equal(fresh.pwc.state_dict()[k], v) for k, v in pwc_sd.items())


def test_read_bundle_equals_tf_get_tensor(jax_bundle):
    prefix, _ = jax_bundle
    reader = tf.train.load_checkpoint(prefix)
    shapes = reader.get_variable_to_shape_map()
    got = tf1_bundle.read_bundle(prefix)
    assert set(got) == set(shapes)
    for name in shapes:
        want = reader.get_tensor(name)
        assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert got["global_step"].dtype == np.int64 and got["global_step"].shape == ()
    assert got["global_step"] == STEP
    assert got["beta1_power"].shape == () and got["beta1_power"] == np.float32(0.9)


def test_port_bundle_reads_through_tf_and_jax(trees, port_bundle, tmp_path):
    prefix, tensors = port_bundle
    # 3000 variables of ~110-byte names fill two of TF's 256 KiB index
    # blocks: the index names several data blocks
    many = {f"{i:05d}/" + "w" * 100: np.full(2, i, np.int32) for i in range(3000)}
    many_prefix = tf1_bundle.write_bundle(str(tmp_path / "many"), many)
    assert len(tf1_bundle._data_blocks(open(many_prefix + ".index", "rb").read(), "")) == 2
    for p, want in ((prefix, tensors), (many_prefix, many)):
        reader = tf.train.load_checkpoint(p)       # TF checks every crc on get_tensor
        assert set(reader.get_variable_to_shape_map()) == set(want)
        for name, value in want.items():
            got = reader.get_tensor(name)
            assert got.dtype == np.asarray(value).dtype, name
            np.testing.assert_array_equal(got, value, err_msg=name)
        mine = tf1_bundle.read_bundle(p)
        assert all(np.array_equal(mine[k], v) for k, v in want.items())
    zeros = Trees(*(_zeros(getattr(trees, f)) for f in TREE_FIELDS), np.int32(0))
    back = jax_import.restore_tf1_full(prefix, zeros)
    for f in TREE_FIELDS:
        want, got = dict(_leaves(getattr(trees, f))), dict(_leaves(getattr(back, f)))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=str(k))
    assert int(back.step) == STEP


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in tree.items()}


def test_crc32c_matches_plain_and_standard_vector():
    assert crc32c(b"123456789") == crc32c_plain(b"123456789") == 0xE3069283
    rs = np.random.RandomState(0)
    for n in (0, 1, 7, 8, 9, 63, 4097):
        data = rs.randint(0, 256, n).astype(np.uint8)
        assert crc32c(data) == crc32c(data.tobytes()) == crc32c_plain(data.tobytes()), n
        head, tail = data[:n // 3], data[n // 3:]
        assert crc32c(tail, crc32c(head)) == crc32c(data)
    # the masked form that bundles store, as TF's Saver stored it for [0..5]
    assert mask(crc32c(np.arange(6, dtype=np.float32))) == 0x173DDBC0


def _tiny(tmp_path, name="model", **tensors):
    tensors = tensors or {"a/x": np.arange(6, dtype=np.float32).reshape(2, 3),
                          "b": np.int64(7), "c": np.arange(3, dtype=np.int32)}
    return tf1_bundle.write_bundle(str(tmp_path / name), tensors)


def _rewrite_entry(prefix, name, edit):
    """Rewrite one entry of a bundle's index through `edit(entry_bytes)`."""
    index = open(prefix + ".index", "rb").read()
    entries = [(k, bytes(v)) for k, v in tf1_bundle._table(index, prefix)]
    entries = [(k, edit(v) if k == name.encode() else v) for k, v in entries]
    with open(prefix + ".index", "wb") as fh:
        fh.write(tf1_bundle._table_bytes(entries))


def test_tiny_bundle_is_tf_saver_bytes(tmp_path):
    # the layout of a TF 2.21 Saver's bundle of these three variables,
    # byte for byte (the index's header, entries, blocks and footer)
    prefix = _tiny(tmp_path)
    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        tf_vars = [tf1.get_variable("a/x", initializer=np.arange(6, dtype=np.float32)
                                    .reshape(2, 3)),
                   tf1.get_variable("b", initializer=np.int64(7)),
                   tf1.get_variable("c", initializer=np.arange(3, dtype=np.int32))]
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            want = tf1.train.Saver(tf_vars).save(sess, str(tmp_path / "tf" / "model"),
                                                 write_meta_graph=False)
    for suffix in (".index", ".data-00000-of-00001"):
        assert open(prefix + suffix, "rb").read() == open(want + suffix, "rb").read(), suffix


@pytest.mark.parametrize("fault", ["data_byte", "data_crc_field", "dtype", "sliced",
                                   "big_endian", "compressed", "block_crc"])
def test_read_refuses_damaged_and_foreign_bundles(tmp_path, fault):
    prefix = _tiny(tmp_path)
    match = "'a/x'"
    if fault == "data_byte":
        data = bytearray(open(prefix + ".data-00000-of-00001", "rb").read())
        data[5] ^= 0x01
        open(prefix + ".data-00000-of-00001", "wb").write(bytes(data))
        match = "'a/x': crc32c mismatch"
    elif fault == "data_crc_field":
        _rewrite_entry(prefix, "a/x", lambda v: v[:-4] + struct.pack("<I", 12345))
        match = "'a/x': crc32c mismatch"
    elif fault == "dtype":
        _rewrite_entry(prefix, "a/x", lambda v: b"\x08\x02" + v[2:])     # DT_DOUBLE
        match = "'a/x': dtype enum 2"
    elif fault == "sliced":
        _rewrite_entry(prefix, "a/x", lambda v: v + b"\x3a\x00")          # slices {}
        match = "'a/x' is sliced"
    elif fault == "big_endian":
        _rewrite_entry(prefix, "", lambda v: v + b"\x10\x01")             # endianness BIG
        match = "'a/x': the bundle's data is big-endian"
    else:
        index = bytearray(open(prefix + ".index", "rb").read())
        ((_, _, size),) = tf1_bundle._data_blocks(bytes(index), prefix)
        index[size if fault == "compressed" else 3] ^= 0x01
        if fault == "compressed":        # type 1 (snappy), its crc made to agree
            index[size + 1:size + 5] = struct.pack("<I", mask(crc32c(bytes(index[:size + 1]))))
        open(prefix + ".index", "wb").write(bytes(index))
        match = "compressed" if fault == "compressed" else "crc32c mismatch in the block at 0"
    with pytest.raises(tf1_bundle.BundleError, match=match):
        tf1_bundle.read_bundle(prefix)


def test_restore_refuses_missing_wrong_shape_and_other_range(trees, port_bundle, tmp_path):
    prefix, tensors = port_bundle
    short = dict(tensors)
    del short["pwcnet/ctxt/dc_conv23/bias"]
    path = tf1_bundle.write_bundle(str(tmp_path / "short"), short)
    with pytest.raises(ValueError, match="no variable 'pwcnet/ctxt/dc_conv23/bias'"):
        tf1_import.restore_tf1_full(path, _port_state())
    wrong = dict(tensors, **{"FlownetS//aconv1/weights": np.zeros((3, 3, 5, 7), np.float32)})
    path = tf1_bundle.write_bundle(str(tmp_path / "wrong"), wrong)
    with pytest.raises(ValueError, match=r"'FlownetS//aconv1/weights' has shape \(3, 3, 5, 7\)"):
        tf1_import.restore_tf1_scope(path, _port_state(), "recover")
    with pytest.raises(ValueError, match="search range 2, but --pwc_search_range=4"):
        tf1_import.restore_tf1_scope(prefix, _port_state(search_range=4), "pwc")
    with pytest.raises(ValueError, match="search range 2, but --pwc_search_range=4"):
        tf1_import.load_tf1_eval(prefix, 4)
    assert tf1_import.is_tf_checkpoint(prefix) and not tf1_import.is_tf_checkpoint("")
    assert not tf1_import.is_tf_checkpoint(prefix + ".index")
    with pytest.raises(OSError):
        tf1_bundle.read_bundle(str(tmp_path / "missing"))
