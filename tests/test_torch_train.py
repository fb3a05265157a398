"""The port's training entry point on the CPU: `TrainPipeline` batches
bit-equal to the JAX pipeline's (raw and host mode), training saves
(round trip, `latest_checkpoint`, pruning to 40), an interrupted and
resumed run against an uninterrupted one, the exporter on the committed
game save, the train CLI on a synthetic tree from TF1 bundles of the flow
and recover nets, with its TensorBoard summaries under the JAX driver's
tags and `test_generator` reading its `model.best`, and the CLI's
refusals."""

import importlib
import importlib.util
import os
import struct

import numpy as np
import pytest
import torch

from synthetic import make_moving_square_davis, make_segtrack_tree
from torch_parity import GAME_CKPT, PWC_CKPT, REPO, assert_trees_equal, torch_threads
from unsupervised_detection_tpu import data as jdata
from unsupervised_detection_tpu.train import checkpoint as jax_ckpt
from unsupervised_detection_tpu_torch import Config, convert, data
from unsupervised_detection_tpu_torch import test_generator as eval_cli
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet
from unsupervised_detection_tpu_torch.train import checkpoint as ckpt
from unsupervised_detection_tpu_torch.train import tf1_bundle, tf1_export
from unsupervised_detection_tpu_torch.train.driver import train
from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner

train_cli = importlib.import_module("unsupervised_detection_tpu_torch.train.__main__")


_threads = torch_threads(1)


READER = dict(img_height=32, img_width=64, reader_height=64, reader_width=128)


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    return make_moving_square_davis(str(tmp_path_factory.mktemp("davis")), frames=10,
                                    hw=(128, 192))


def _first_batches(pipe, n):
    it = iter(pipe)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("dataset", ["DAVIS2016", "SEGTRACK"])
def test_train_pipeline_bit_equal_to_jax(dataset, davis_root, tmp_path_factory):
    # DAVIS feeds raw uint8 frames, SegTrack host-resized float32 ones; 7
    # batches of 4 run past the first epoch's permutation
    root = davis_root if dataset == "DAVIS2016" else make_segtrack_tree(
        str(tmp_path_factory.mktemp("segtrack")))
    partition = "trainval" if dataset == "DAVIS2016" else "all"

    def pipe(pkg):
        reader = pkg.get_reader(dataset, root, max_temporal_len=2, min_temporal_len=1,
                                num_threads=2)
        raw_hw = (reader.raw_height, reader.raw_width) if reader.raw_height else None
        return pkg.TrainPipeline(reader.dataset(partition), 4, 1, 2, reader_hw=(64, 128),
                                 raw_hw=raw_hw, num_threads=2, seed=5)

    got, want = _first_batches(pipe(data), 7), _first_batches(pipe(jdata), 7)
    keys = {"img1_raw", "img2_raw"} if dataset == "DAVIS2016" else {"img1", "img2"}
    for g, w in zip(got, want):
        assert set(g) == set(w) == keys
        for k in keys:
            assert g[k].dtype == w[k].dtype and g[k].shape[0] == 4
            np.testing.assert_array_equal(g[k], w[k])
    # another seed, another stream
    other = pipe(data)
    other.rng = np.random.RandomState(6)
    assert not np.array_equal(_first_batches(other, 1)[0][sorted(keys)[0]],
                              got[0][sorted(keys)[0]])


def _trained_state(steps=4, seed=0):
    """A port state on the CPU after `steps` sub-steps on random frames."""
    cfg = Config(batch_size=2, pwc_search_range=2, seed=seed, **READER)
    learner = AdversarialLearner(cfg, device="cpu")
    state = learner.init_state()
    rs = np.random.RandomState(seed)
    img1, img2 = (torch.from_numpy(rs.uniform(-0.5, 0.5, (2, 64, 128, 3)).astype(np.float32))
                  for _ in range(2))
    for sub_step in range(1, steps + 1):
        state, _, _ = learner.select_step(sub_step)(state, img1, img2)
        if sub_step % 4 == 0:
            state = learner.incr_step(state)
    return learner, state


def test_save_restore_round_trip_and_latest(tmp_path):
    _, state = _trained_state()
    assert (state.step, state.gen_opt.count, state.rec_opt.count) == (1, 3, 1)
    d = str(tmp_path)
    assert ckpt.latest_checkpoint(d) is None
    for epoch in (1, 3, 2):
        ckpt.save_epoch(d, epoch, state)
    best = ckpt.save_best(d, state)
    assert ckpt.latest_checkpoint(d) == os.path.join(d, "model-3")
    assert ckpt.checkpoint_exists(best) and not ckpt.checkpoint_exists(str(tmp_path / "no"))

    _, fresh = _trained_state(steps=0, seed=1)
    ckpt.restore_checkpoint(best, fresh)
    assert_trees_equal(ckpt.train_trees(fresh), ckpt.train_trees(state))
    # the generator's stream continues where the saved one stopped
    assert torch.equal(torch.rand(4, generator=fresh.rng), torch.rand(4, generator=state.rng))
    # model.best is also an evaluation checkpoint
    gen_sd, pwc_sd = ckpt.load_eval_checkpoint(best, 2)
    assert all(torch.equal(gen_sd[k], v) for k, v in state.generator.state_dict().items())
    assert all(torch.equal(pwc_sd[k], v) for k, v in state.pwc.state_dict().items())
    with pytest.raises(ValueError, match="search range 2"):
        ckpt.restore_checkpoint(best, AdversarialLearner(
            Config(pwc_search_range=4, **READER), device="cpu").init_state())


def test_epoch_saves_pruned_to_40(tmp_path):
    d = str(tmp_path)
    for epoch in range(1, 46):
        open(os.path.join(d, f"model-{epoch}"), "w").close()
    open(os.path.join(d, "model.best"), "w").close()
    _, state = _trained_state(steps=0)
    ckpt.save_epoch(d, 46, state)
    epochs = sorted(int(n.split("-")[1]) for n in os.listdir(d) if n.startswith("model-"))
    assert epochs == list(range(7, 47)) and len(epochs) == ckpt.MAX_TO_KEEP
    assert os.path.exists(os.path.join(d, "model.best"))


def _cfg(root, ckpt_dir, max_epochs, **kw):
    return Config(root_dir=root, checkpoint_dir=ckpt_dir, batch_size=8,
                  num_samples_train=32,  # 4 sub-steps: one cycle per epoch
                  max_epochs=max_epochs, summary_freq=100, save_freq=1, num_threads=2,
                  pwc_search_range=2, allow_random_flow=True, **READER, **kw)


def test_interrupt_and_resume(davis_root, tmp_path):
    # uninterrupted: 2 epochs, saving model-1 on the way
    whole_dir, cut_dir = str(tmp_path / "whole"), str(tmp_path / "cut")
    os.makedirs(whole_dir)
    os.makedirs(cut_dir)
    whole = train(_cfg(davis_root, whole_dir, 2), verbose=False, device="cpu")
    # interrupted after epoch 1: its save is the uninterrupted run's, bit for bit
    cut = train(_cfg(davis_root, cut_dir, 1), verbose=False, device="cpu")
    saved = ckpt.latest_checkpoint(cut_dir)
    assert saved.endswith("model-1")
    assert_trees_equal(ckpt.load_trees(saved),
                        ckpt.load_trees(os.path.join(whole_dir, "model-1")))
    on_file = ckpt.load_trees(saved)
    assert int(on_file.pop(ckpt.RANGE_KEY)) == 2
    assert_trees_equal(on_file, ckpt.train_trees(cut))

    # resumed: restores model-1 exactly and trains max_epochs more (the
    # reference restarts its local counter; the global step keeps counting)
    resumed = train(_cfg(davis_root, cut_dir, 1, resume_train=True), verbose=False,
                    device="cpu")
    for s in (resumed, whole):
        assert (s.step, s.gen_opt.count, s.rec_opt.count, s.shared_adam_t) == (2, 6, 2, 9)
    assert ckpt.checkpoint_exists(os.path.join(cut_dir, "model-1"))
    moved = max(float((a - b).abs().max()) for a, b in zip(
        resumed.recover.parameters(), cut.recover.parameters()))
    assert 0.0 < moved < 1e-2


def _exporter():
    path = os.path.join(REPO, "tools", "export_torch_checkpoint.py")
    spec = importlib.util.spec_from_file_location("export_torch_checkpoint", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_export_committed_game_state(tmp_path):
    out = str(tmp_path / "game.npz")
    assert _exporter().main(["--train", out, GAME_CKPT, PWC_CKPT]) == 0
    fields = dict(jax_ckpt._checkpointer().restore(GAME_CKPT)["state"])
    fields["pwc_params"] = jax_ckpt._checkpointer().restore(PWC_CKPT)
    want = convert.from_jax_train_state(fields)

    state = AdversarialLearner(Config(pwc_search_range=2, **READER), device="cpu").init_state()
    rng_before = state.rng.get_state()
    ckpt.restore_checkpoint(out, state)
    for net, key in ((state.generator, "gen"), (state.recover, "rec"), (state.pwc, "pwc")):
        got = net.state_dict()
        assert set(got) == set(want[key])
        assert all(torch.equal(got[k], v) for k, v in want[key].items()), key
    for name in ("gen_opt", "rec_opt"):
        opt = getattr(state, name)
        assert opt.count == want[name]["count"]
        for moment in ("m", "v"):
            got = getattr(opt, moment)
            assert set(got) == set(want[name][moment])
            assert all(torch.equal(got[k], v) for k, v in want[name][moment].items())
    assert state.step == want["step"]
    assert torch.equal(state.rng.get_state(), rng_before)   # no JAX key carried over

    # scope saves for --flow_ckpt and --recover_ckpt
    for scope, net, key, ckpt_file in (("pwc_params", state.pwc, "pwc", PWC_CKPT),
                                       ("rec_params", state.recover, "rec", GAME_CKPT)):
        path = str(tmp_path / f"{scope}.npz")
        assert _exporter().main([f"--scope={scope}", path, ckpt_file]) == 0
        with torch.no_grad():
            for p in net.parameters():
                p.zero_()
        ckpt.restore_params_scope(path, net, scope)
        assert all(torch.equal(net.state_dict()[k], v) for k, v in want[key].items())


def _cli_flags(root, ckpt_dir):
    return [f"--root_dir={root}", f"--checkpoint_dir={ckpt_dir}", "--batch_size=8",
            "--num_samples_train=16", "--max_epochs=1", "--summary_freq=1", "--save_freq=1",
            "--num_threads=2", "--pwc_search_range=2", "--img_height=32", "--img_width=64",
            "--reader_height=64", "--reader_width=128"]


def _tf1_scope(prefix, net):
    """A TF1 bundle of one port network's weights under the reference's
    names."""
    return tf1_bundle.write_bundle(prefix, tf1_export.tf1_tensors(net))


def _event_tags(path):
    """{"scalars", "histograms", "images"}: the tags of an event file's
    summaries, read with tensorboardX's protos (TFRecord framing: length,
    its crc, the record, its crc)."""
    from tensorboardX.proto import event_pb2

    tags = {"scalars": set(), "histograms": set(), "images": set()}
    data, pos = open(path, "rb").read(), 0
    while pos < len(data):
        (n,) = struct.unpack_from("<Q", data, pos)
        event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
        pos += 12 + n + 4
        for v in event.summary.value:
            kind = v.WhichOneof("value")
            tags[{"simple_value": "scalars", "histo": "histograms", "image": "images"}[kind]].add(
                v.tag)
    return tags


LOSS_KEYS = ("generator", "recover", "red_rate", "red_rate_compl", "reconstruction_loss",
             "reconstruction_compl_loss", "denominator_red_rate",
             "denominator_red_rate_compl")
SUMMARY_IMAGES = ("input_image", "next_image", "masked_flow", "PWC_Flow", "Rec_flow",
                  "Rec_flow_compl")


def test_train_cli_then_test_generator(davis_root, tmp_path, capsys):
    # the flow and recover nets come from TF1 bundles; a TF1 --recover_ckpt
    # is restored, where the JAX driver skips it (its checkpoint_exists asks
    # for a directory)
    torch.manual_seed(5)
    pwc, recover = PWCNet(search_range=2), RecoverNet()
    flow_ckpt = _tf1_scope(str(tmp_path / "pwc" / "model"), pwc)
    recover_ckpt = _tf1_scope(str(tmp_path / "rec" / "model.ckpt-100"), recover)
    ckpt_dir = str(tmp_path / "ck")
    state = train_cli.main(_cli_flags(davis_root, ckpt_dir) + [
        f"--flow_ckpt={flow_ckpt}", f"--recover_ckpt={recover_ckpt}"], device="cpu")
    out = capsys.readouterr().out
    assert f"Flow net loaded from {flow_ckpt}" in out
    assert "Recover net loaded from previous ckpt" in out
    assert "Training completed successfully" in out
    assert "Epoch: [ 1] [    2/    2] time: " in out and "loss_generator: " in out
    assert "Epoch [1] Validation IoU: " in out
    events = [f for f in os.listdir(ckpt_dir) if f.startswith("events.out.tfevents.")]
    assert len(events) == 1
    assert sorted(set(os.listdir(ckpt_dir)) - set(events)) == ["model-1", "model.best"]
    assert (state.gen_opt.count, state.rec_opt.count) == (2, 0)
    # the generator alone stepped: PWC (frozen) and the recover net keep the
    # bundles' weights, bit for bit
    for net, src in ((state.pwc, pwc), (state.recover, recover)):
        assert all(torch.equal(net.state_dict()[k], v) for k, v in src.state_dict().items())
    # the summaries of both sub-steps (generator steps) under the JAX
    # driver's tags: gradient histograms named by the flax paths
    tags = _event_tags(os.path.join(ckpt_dir, events[0]))
    assert tags["scalars"] == set(LOSS_KEYS) | {"samples_per_sec", "IoU_on_Validation"}
    paths = convert.flax_paths(GeneratorNet())
    assert tags["histograms"] == {f"MaskNet/{'/'.join(paths[name][1:])}/gradients"
                                  for name, _ in GeneratorNet().named_parameters()}
    assert "MaskNet/conv13_upsample/conv/conv/kernel/gradients" in tags["histograms"]
    assert tags["images"] == set(SUMMARY_IMAGES)
    results = eval_cli.main([f"--root_dir={davis_root}",
                              f"--ckpt_file={ckpt_dir}/model.best", "--batch_size=8",
                              "--pwc_search_range=2", "--img_height=32", "--img_width=64",
                              "--reader_height=64", "--reader_width=128"], device="cpu")
    assert "The Average over the dataset: IoU is" in capsys.readouterr().out
    assert results["frames"] == 16


def test_train_cli_refusals(davis_root, tmp_path):
    flags = _cli_flags(davis_root, str(tmp_path / "ck"))
    with pytest.raises(SystemExit, match="No checkpoint for the flow network"):
        train_cli.main(flags, device="cpu")
    for mesh in ("--mesh_data=2", "--mesh_model=2"):
        with pytest.raises(SystemExit, match="no mesh"):
            train_cli.main(flags + [mesh, "--allow_random_flow"], device="cpu")
    # TF1 bundles: a flow bundle of another search range, and a resume from
    # one (a resume reads the port's training saves, as JAX reads its own)
    tf1 = _tf1_scope(str(tmp_path / "model.ckpt-100"), PWCNet(search_range=4))
    with pytest.raises(ValueError, match="search range 4, but --pwc_search_range=2"):
        train_cli.main(flags + [f"--flow_ckpt={tf1}"], device="cpu")
    with pytest.raises(SystemExit, match="is a TF1 bundle"):
        train_cli.main(flags + ["--allow_random_flow", "--resume_train",
                                f"--full_model_ckpt={tf1}"], device="cpu")
    with pytest.raises(SystemExit, match="Found no checkpoint to resume"):
        train_cli.main(flags + ["--allow_random_flow", "--resume_train",
                                f"--checkpoint_dir={tmp_path / 'empty'}"], device="cpu")
