"""The port's data side against the JAX package's, on the CPU: readers and
pair indices, FBMS test tuples and GT binarization, `TestPipeline` batches
(raw mode for DAVIS, host mode for FBMS tuples and SegTrack, the wrapped
last batch included), `DeviceFeeder`, `get_reader` and flag parsing.

Trees come from tests/synthetic.py; the reader resolution is 64x128."""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from synthetic import make_fbms_tree, make_moving_square_davis, make_segtrack_tree
from unsupervised_detection_tpu import data as jdata
from unsupervised_detection_tpu.config import Config as JaxConfig
from unsupervised_detection_tpu.config import parse_flags as jax_parse_flags
from unsupervised_detection_tpu.data.base import test_pair_index as jax_test_pair_index
from unsupervised_detection_tpu.data.base import train_pair_index as jax_train_pair_index
from unsupervised_detection_tpu.data.device_input import DeviceFeeder as JaxDeviceFeeder
from unsupervised_detection_tpu.parallel.mesh import make_mesh
from unsupervised_detection_tpu_torch import Config, data, parse_flags
from unsupervised_detection_tpu_torch.data.base import test_pair_index as make_test_pair_index
from unsupervised_detection_tpu_torch.data.base import train_pair_index
from unsupervised_detection_tpu_torch.data.device_input import DeviceFeeder

READER_HW = (64, 128)
BATCH = 8
# DeviceFeeder images: the same float32 matrices applied in other summation
# orders (XLA HIGHEST vs oneDNN) -> within 1e-5 of values in [-0.5, 0.5].
# Masks take one-hot matrices: exact.
FEED_ATOL = 1e-5


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    # 2 sequences x 10 frames: the trainval stream of 20 samples ends in a
    # wrapped batch of 8 (4 real + 4 repeated)
    return make_moving_square_davis(str(tmp_path_factory.mktemp("davis")), frames=10,
                                    hw=(128, 192))


@pytest.fixture(scope="module")
def segtrack_root(tmp_path_factory):
    return make_segtrack_tree(str(tmp_path_factory.mktemp("segtrack")))


def _fbms_root(tmp_path_factory, name):
    return make_fbms_tree(str(tmp_path_factory.mktemp(name)))


def _assert_dataset_equal(got, want):
    assert (got.name, got.sequences, got.image_files, got.annotation_files) == (
        want.name, want.sequences, want.image_files, want.annotation_files)
    assert got.samples_per_category == want.samples_per_category
    for attr in ("flat_images", "flat_annotations", "flat_categories"):
        np.testing.assert_array_equal(getattr(got, attr)(), getattr(want, attr)())


def _assert_index_equal(got, want):
    for attr in ("numbers", "directions", "images", "annotations", "categories"):
        a, b = getattr(got, attr), getattr(want, attr)
        if b is None:
            assert a is None, attr
        else:
            assert a.dtype == b.dtype, attr
            np.testing.assert_array_equal(a, b, err_msg=attr)


@pytest.mark.parametrize("partition", ["train", "val", "trainval"])
def test_davis_reader_and_pair_indices_match_jax(davis_root, partition):
    got = data.Davis2016Reader(davis_root, max_temporal_len=2).dataset(partition)
    want = jdata.Davis2016Reader(davis_root, max_temporal_len=2).dataset(partition)
    _assert_dataset_equal(got, want)
    for t_len in (-2, -1, 1, 2):
        _assert_index_equal(make_test_pair_index(got, t_len), jax_test_pair_index(want, t_len))
    for t in (1, 2, 3):
        _assert_index_equal(train_pair_index(got, t), jax_train_pair_index(want, t))


def test_segtrack_reader_matches_jax(segtrack_root):
    got = data.SegTrackV2Reader(segtrack_root).dataset("val")
    want = jdata.SegTrackV2Reader(segtrack_root).dataset("val")
    _assert_dataset_equal(got, want)
    assert (data.SegTrackV2Reader.raw_height, data.SegTrackV2Reader.raw_width) == (None, None)
    for t_len in (-1, 1, 2):
        _assert_index_equal(make_test_pair_index(got, t_len), jax_test_pair_index(want, t_len))


@pytest.mark.parametrize("shift", [1, -1, 2])
def test_fbms_test_tuples_and_gt_match_jax(tmp_path_factory, shift):
    # preprocess_gt_once writes binarized GT into the tree: each side gets
    # its own identical tree, compared through paths relative to the root
    jax_root = _fbms_root(tmp_path_factory, "fbms_jax")
    port_root = _fbms_root(tmp_path_factory, "fbms_port")
    want_reader = jdata.FBMS59Reader(jax_root)
    got_reader = data.FBMS59Reader(port_root)
    want = want_reader.test_tuples("val", shift)
    got = got_reader.test_tuples("val", shift)

    def rel(tuples, root):
        return sorted(tuple(os.path.relpath(x, root) if isinstance(x, str) and x.startswith(root)
                            else x for x in t) for t in tuples)

    assert rel(got, port_root) == rel(want, jax_root)
    assert got_reader.samples_per_cat == want_reader.samples_per_cat
    assert got_reader.num_categories == want_reader.num_categories
    for (_, _, ann, _, _), (_, _, jann, _, _) in zip(sorted(got), sorted(want)):
        np.testing.assert_array_equal(cv2.imread(ann), cv2.imread(jann))
    # reading the same tree (no writes): the train dataset and GT discovery
    _assert_dataset_equal(got_reader.dataset("trainval"),
                          jdata.FBMS59Reader(port_root).dataset("trainval"))
    for seq in ("cars1", "marple7"):
        gt_dir = os.path.join(port_root, "Testset", seq, "GroundTruth")
        assert data.fbms.find_gt(gt_dir) == jdata.fbms.find_gt(gt_dir)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                assert g[key] == w[key], key
    return got


@pytest.mark.parametrize("t_len", [1, -2])
def test_davis_test_pipeline_raw_mode_bit_equal(davis_root, t_len):
    ds = data.Davis2016Reader(davis_root).dataset("trainval")
    jds = jdata.Davis2016Reader(davis_root).dataset("trainval")
    raw_hw = (data.Davis2016Reader.raw_height, data.Davis2016Reader.raw_width)
    got = data.TestPipeline(ds, BATCH, t_len, reader_hw=READER_HW, raw_hw=raw_hw, num_threads=3)
    want = jdata.TestPipeline(jds, BATCH, t_len, reader_hw=READER_HW, raw_hw=raw_hw)
    assert (got.num_samples, got.num_steps) == (want.num_samples, want.num_steps) == (20, 3)
    batches = _assert_batches_equal(got, want)
    # raw mode stacks the decoded size (128x192), not the declared 480x854
    assert batches[0]["img1_raw"].shape == (BATCH, 128, 192, 3)
    # the last batch wraps around to the first samples
    assert batches[-1]["fname"][4:] == batches[0]["fname"][:4]


def test_segtrack_test_pipeline_host_mode_bit_equal(segtrack_root):
    ds = data.SegTrackV2Reader(segtrack_root).dataset("all")
    jds = jdata.SegTrackV2Reader(segtrack_root).dataset("all")
    got = data.TestPipeline(ds, BATCH, 1, reader_hw=READER_HW, num_threads=2)
    want = jdata.TestPipeline(jds, BATCH, 1, reader_hw=READER_HW)
    batches = _assert_batches_equal(got, want)
    assert batches[0]["img1"].shape == (BATCH, *READER_HW, 3)
    assert len(batches) == 2        # 10 samples: the second batch wraps


def test_fbms_test_pipeline_tuples_bit_equal(tmp_path_factory):
    root = _fbms_root(tmp_path_factory, "fbms_pipe")
    tuples = jdata.FBMS59Reader(root).test_tuples("val", 1)
    got = data.TestPipeline(None, BATCH, 1, reader_hw=READER_HW, explicit_tuples=tuples,
                            num_threads=4)
    want = jdata.TestPipeline(None, BATCH, 1, reader_hw=READER_HW, explicit_tuples=tuples)
    batches = _assert_batches_equal(got, want)
    assert got.num_samples == 6 and len(batches) == 1


def test_host_loader_keeps_order_under_prefetch():
    # results come back in spec order however the threads finish
    import time

    def slow(i):
        time.sleep(0.002 * (7 - i % 8))
        return i

    loader = data.HostLoader(num_threads=8, prefetch=3)
    assert list(loader.prefetched(range(40), slow)) == list(range(40))
    assert list(loader.prefetched(range(2), slow)) == [0, 1]
    assert list(loader.prefetched([], slow)) == []


def test_device_feeder_matches_jax(davis_root):
    ds = data.Davis2016Reader(davis_root).dataset("trainval")
    raw = next(iter(data.TestPipeline(ds, BATCH, 1, reader_hw=READER_HW, raw_hw=(480, 854))))
    host = next(iter(data.TestPipeline(ds, BATCH, 1, reader_hw=READER_HW)))
    want_feeder = JaxDeviceFeeder(make_mesh(batch_size=BATCH), READER_HW)
    feeder = DeviceFeeder(READER_HW, device="cpu")
    for batch in (raw, host):
        got_img, want_img = feeder.images(batch), want_feeder.images(batch)
        for g, w in zip(got_img, want_img):
            assert g.dtype == torch.float32 and g.shape == (BATCH, *READER_HW, 3)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FEED_ATOL)
        np.testing.assert_array_equal(feeder.mask(batch).numpy(),
                                      np.asarray(want_feeder.mask(batch)))


def test_device_feeder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFeeder(READER_HW)


def test_get_reader_dispatch_and_error_text(davis_root):
    assert isinstance(data.get_reader("DAVIS2016", davis_root), data.Davis2016Reader)
    assert isinstance(data.get_reader("FBMS", davis_root), data.FBMS59Reader)
    assert isinstance(data.get_reader("SEGTRACK", davis_root), data.SegTrackV2Reader)
    with pytest.raises(OSError) as want:
        jdata.get_reader("BOGUS", davis_root)
    with pytest.raises(OSError) as got:
        data.get_reader("BOGUS", davis_root)
    assert str(got.value) == str(want.value) == "Dataset should be DAVIS2016 / FBMS / SEGTRACK"


def _flag_cases():
    """(argv, field) for every field of the port's Config, bools in every
    gflags form."""
    values = {"int": "7", "float": "0.25", "str": "/some/path"}
    for f in dataclasses.fields(Config):
        if f.type == "bool":
            for argv in ([f"--{f.name}"], [f"--{f.name}=False"], [f"--{f.name}=true"],
                         [f"--{f.name}=1"], [f"--no{f.name}"], [f"--{f.name}", f"--no{f.name}"]):
                yield argv, f.name
        else:
            yield [f"--{f.name}={values[f.type]}"], f.name
            yield [f"--{f.name}", values[f.type]], f.name


def test_every_flag_parses_as_in_jax():
    cases = list(_flag_cases())
    assert any(name == "generate_visualization" for _, name in cases)
    for argv, name in cases:
        got, want = parse_flags(argv), jax_parse_flags(argv)
        assert getattr(got, name) == getattr(want, name), argv
        assert type(getattr(got, name)) is type(getattr(want, name)), argv
    # the new fields keep the JAX flag's default
    jax_defaults = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for name in ("dataset", "root_dir", "test_partition", "test_temporal_shift", "num_threads",
                 "max_temporal_len", "min_temporal_len", "ckpt_file", "test_save_dir",
                 "generate_visualization", "seed"):
        assert getattr(Config(), name) == jax_defaults[name], name
    for argv in (["--bogus=1"], ["--nobatch_size"]):
        with pytest.raises(SystemExit, match="Unknown flag"):
            parse_flags(argv)
