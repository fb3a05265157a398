"""The port's mesh (parallel/mesh.py) on the CPU: 2, 3 and 4 gloo ranks
spawned from this process against the same calls in one process.

Each spawned world runs once per file (module-scoped fixtures), while this
process computes the one-process side; the ranks import
tests/torch_mesh_workers.py and the port, not JAX. The cases name the traps
a data-parallel port falls into:

* the players reduce differently (the generator's loss is a mean over the
  global batch, the recover's a sum over it divided by its pixel count):
  one step of each on (2,1) and (2,2) meshes against one process;
* reduce over the data group only: on (2,2) a reduction over all 4 ranks
  would double every gradient;
* reduce before the clip and the noise: the noise test is on the global
  gradient, and its draws are the same on every rank;
* draws for the global batch on every rank: parameters stay bit-equal
  across ranks;
* logged losses: the sample-0 entries come from data index 0, `val_step`
  sums over the data group;
* evaluation: per-frame results gathered in global order, the wrapped last
  batch's duplicates numbered as one process numbers them, the same set of
  files;
* PWC pretraining has no mesh in JAX: `pretrain_flow` refuses a world of 2.

Limits: one step on a mesh against one process within rtol 2e-5 / atol
2e-6 (tests/test_train_step.py:140-146, the JAX package's own mesh
equivalence), the evaluation and ensemble metrics within 1e-5; the model
axis's cost volume is exact (every element has one nonzero term), so it is
held bit-equal to the whole volume, and within 1e-6 of JAX's
offset-sharded `_cost_volume_xla`.
"""

import os
import socket

import numpy as np
import pytest
import scipy.io as sio
import torch

import torch_mesh_workers as workers
from synthetic import make_moving_square_davis
from torch_parity import torch_threads
from unsupervised_detection_tpu_torch.ops.cost_volume import cost_volume_plain, dy_rows
from unsupervised_detection_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_from_env

_threads = torch_threads(1)

RTOL, ATOL = 2e-5, 2e-6
METRIC_TOL = 1e-5
# the train CLI's 4 sub-steps (3 generator, 1 recover, each feeding the
# next) and validation: the step limits, four times over
CLI_RTOL, CLI_ATOL = 8e-5, 8e-6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A DAVIS tree of 2 x 7 frames at 64x128 (trainval: 14 pairs, so batch
    4 wraps 2 duplicates into the last batch) and an evaluation checkpoint."""
    tmp = tmp_path_factory.mktemp("mesh_tree")
    root = make_moving_square_davis(str(tmp / "davis"), frames=7, hw=(64, 128), square=16)
    return root, workers.write_checkpoint(str(tmp / "weights.npz"))


@pytest.fixture(scope="module")
def world2(tree, tmp_path_factory):
    """(tmp, each rank's results, the one-process results)."""
    tmp = str(tmp_path_factory.mktemp("world2"))
    ranks = workers.Spawned(workers.case_world2, 2, tmp, root=tree[0], ckpt=tree[1])
    one = {"steps": workers.run_steps(Mesh()), "noise": workers.run_noise(Mesh()),
           "pretrain": workers.run_pretrain(Mesh()),
           "eval": workers.run_eval(Mesh(), tree[0], tree[1], os.path.join(tmp, "dense_one")),
           "mask": workers.run_model_axis(Mesh())["mask"]}
    return tmp, ranks.join(), one


@pytest.fixture(scope="module")
def one_process(world2):
    return world2[2]


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return workers.Spawned(workers.case_mesh_semantics, 3,
                           str(tmp_path_factory.mktemp("world3"))).join()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return workers.Spawned(workers.case_world4, 4, str(tmp_path_factory.mktemp("world4"))).join()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _assert_close_trees(got, want, rtol, atol, what):
    assert set(got) == set(want), what
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=atol, msg=f"{what}: {k}")


def _assert_equal_ranks(ranks, what):
    for r, other in enumerate(ranks[1:], start=1):
        for k, v in ranks[0].items():
            assert torch.equal(other[k], v), f"{what}: {k} differs on rank {r}"


def _assert_steps_match(ranks, want):
    for name in ("generator_step", "recover_step"):
        for r, run in enumerate(ranks):
            got = run["steps"][name]
            for k, v in want[name]["losses"].items():
                np.testing.assert_allclose(got["losses"][k], v, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} {k} on rank {r}")
            for g, w in zip(got["grads"], want[name]["grads"]):
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    _assert_close_trees(ranks[0]["steps"]["params"], want["params"], RTOL, ATOL, "params")
    _assert_equal_ranks([run["steps"]["params"] for run in ranks], "params across ranks")
    for run in ranks:
        np.testing.assert_allclose(run["steps"]["val"], want["val"], rtol=RTOL, atol=ATOL)


# --- make_mesh -----------------------------------------------------------------
def test_make_mesh_has_jax_semantics(world3):
    """3 ranks: the default (3, 1) mesh; at batch 4 the data axis shrinks to
    2 with JAX's WARNING (printed once, by rank 0) and rank 2 stays outside;
    an explicit n_data that does not divide the batch raises, naming both."""
    assert [r["default"] for r in world3] == [(3, 1, d, True) for d in range(3)]
    shrink = [r["shrink"] for r in world3]
    assert [s[:5] for s in shrink] == [(2, 1, 0, True, (0, 2)), (2, 1, 1, True, (2, 4)),
                                       (2, 1, 0, False, None)]
    assert shrink[0][5] == ("WARNING: batch_size=4 does not split over 3 devices; using a "
                            "2-device data axis (1 devices idle). Pick a batch divisible by "
                            "the device count for full utilization.\n")
    assert shrink[1][5] == shrink[2][5] == ""
    for r in world3:
        assert "mesh_data=3" in r["error"] and "batch_size=4" in r["error"]


def test_trivial_mesh_is_one_process():
    """No process group: the (1, 1) mesh, no collectives, every row."""
    mesh = make_mesh(batch_size=4)
    assert mesh == Mesh() and mesh.group is None and mesh.is_main
    x = torch.arange(8.0)
    assert mesh.shard(x) is x and mesh.gather_data(x) is x
    assert mesh.sum_data([x])[0] is x and mesh.sum_model(x) is x
    assert mesh.batch_rows(4) is None
    assert dy_rows(2, 1, 0) == (0, 5)
    assert [dy_rows(2, 3, i) for i in range(3)] == [(0, 2), (2, 4), (4, 5)]
    assert [dy_rows(2, 6, i) for i in range(6)][-1] == (5, 5)   # past 2r+1: empty


def test_mesh_from_env_without_torchrun_is_one_process(monkeypatch):
    """Without torchrun's variables: the trivial mesh on the device asked
    for, and a mesh of several processes refused with how to start one."""
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert mesh_from_env(device="cpu") == Mesh(device=torch.device("cpu"))
    with pytest.raises(SystemExit, match="not started by torchrun"):
        mesh_from_env(n_model=2, device="cpu")


def test_mesh_from_env_takes_the_named_backend(tmp_path):
    """2 ranks under torchrun's variables with gloo named (as ranks sharing
    one card name it): a (1, 2) mesh on the CPU, and `sum_data` leaves the
    model group's first rank's sum on both ranks."""
    ranks = workers.Spawned(workers.case_env_backend, 2, str(tmp_path), env=True,
                            port=_free_ports(1)[0]).join()
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert [r["mesh"] for r in ranks] == [(1, 2, 0, 0, "cpu"), (1, 2, 0, 1, "cpu")]
    for r in ranks:
        assert torch.equal(r["sum"][0], torch.ones(3)) and r["sum"][1].item() == 0


# --- the model axis ------------------------------------------------------------
@pytest.mark.parametrize("world", (2, 3))
def test_model_axis_cost_volume_is_the_whole_volume(world, world2, world3):
    """Each rank of a (1, n) mesh computes its dy rows (n=2: 3 and 2 of r=2's
    5; n=3: 2, 2 and 1) and the model group sums the volumes: bit-equal to
    the whole plain volume on every rank, in both dtypes."""
    ranks = [r["model_axis"] for r in (world2[1] if world == 2 else world3)]
    want_rows = [dy_rows(2, world, i) for i in range(world)]
    for dtype in (torch.float32, torch.bfloat16):
        c1, warp = workers.cost_volume_inputs(dtype)
        whole = cost_volume_plain(c1, warp, 2)
        assert [r[str(dtype)]["rows"] for r in ranks] == want_rows
        for r in ranks:
            assert torch.equal(r[str(dtype)]["volume"], whole), dtype


@pytest.mark.parametrize("world", (2, 3))
def test_model_axis_forward_mask_bit_equal(world, world2, world3, one_process):
    """The Evaluator's masks on a (1, n) mesh, PWC's five cost volumes split
    over the model group, are one process's bit for bit."""
    ranks = [r["model_axis"]["mask"] for r in (world2[1] if world == 2 else world3)]
    want = one_process["mask"]
    for mask in ranks:
        assert torch.equal(mask, want)


def test_model_axis_matches_jax_offset_sharding(world2):
    """The (1, 2) mesh's volume against JAX's `_cost_volume_xla` with its
    offsets sharded over a virtual (1, 2) device mesh: within 1e-6."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from unsupervised_detection_tpu.ops.cost_volume import _cost_volume_xla
    from unsupervised_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh

    jmesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    sharding = NamedSharding(jmesh, P(None, "model", None, None))
    c1, warp = workers.cost_volume_inputs()
    want = np.asarray(jax.jit(lambda a, b: _cost_volume_xla(a, b, 2, sharding))(
        c1.numpy(), warp.numpy()))
    for r in world2[1]:
        np.testing.assert_allclose(r["model_axis"]["torch.float32"]["volume"].numpy(), want,
                                   rtol=0, atol=1e-6)


# --- the learner -----------------------------------------------------------------
def test_data_parallel_steps_match_one_process(world2, one_process):
    """(2, 1): a generator step (loss: a mean over the global batch) and a
    recover step (a sum over it over its pixel count), each rank on its 2
    rows of the same global draws, against one process: the 8 losses (the
    sample-0 ones from data index 0), the applied gradients, the parameters
    after both steps (bit-equal across ranks) and val_step's IoU sum."""
    ranks = world2[1]
    assert [r["mesh"] for r in ranks] == [(2, 1, 0, 0), (2, 1, 1, 0)]
    _assert_steps_match(ranks, one_process["steps"])


def test_data_and_model_axes_match_one_process(world4, one_process):
    """(2, 2): as the (2, 1) case, with PWC's cost volume split over each
    model group. The gradients are reduced over the data group only: over
    all 4 ranks they would come out twice as large."""
    assert [r["mesh"] for r in world4] == [(2, 2, d, m) for d in range(2) for m in range(2)]
    _assert_steps_match(world4, one_process["steps"])


def test_generator_noise_drawn_alike_on_every_rank(world2, one_process):
    """The noise test on the global (reduced) gradient fires on both ranks
    at once, and both draw the same noise from their generators, advanced
    alike by the global batch's augmentation draws: the applied gradients,
    the parameters and the generator states are one process's bit for bit."""
    want = one_process["noise"]
    assert all(float(g.min()) >= 0.0 for g in want["grads"])   # |U(-clip, clip)|
    for r in world2[1]:
        got = r["noise"]
        assert all(torch.equal(g, w) for g, w in zip(got["grads"], want["grads"]))
        assert torch.equal(got["rng"], want["rng"])
        _assert_close_trees(got["params"], want["params"], 0, 0, "noised params")


def test_pretrain_recover_step_matches_one_process(world2, one_process):
    """One recover pretraining step on (2, 1): box draws for the global
    batch, the loss over the global pixel count, gradients summed before
    the clip."""
    want = one_process["pretrain"]
    ranks = [r["pretrain"] for r in world2[1]]
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL, atol=ATOL)
        _assert_close_trees(got["params"], want["params"], RTOL, ATOL, "recover params")
    _assert_equal_ranks([r["params"] for r in ranks], "recover params across ranks")


# --- evaluation ------------------------------------------------------------------
def _assert_metrics_close(got, want, what):
    assert got["frames"] == want["frames"] == 16, what      # 14 pairs, 2 wrapped
    assert set(got["category_iou"]) == set(want["category_iou"]), what
    for key in ("category_iou", "category_mae"):
        for cat, v in want[key].items():
            assert abs(got[key][cat] - v) <= METRIC_TOL, (what, key, cat)
    for key in ("dataset_iou", "dataset_mae"):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (what, key)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_evaluate_dataset_and_ensemble_match_one_process(world2, one_process):
    """(2, 1) on 14 pairs at batch 4, the last batch wrapped: every rank's
    metrics (metrics-only and dense) and the ensemble's per-frame crop means
    are one process's; rank 0 wrote the dense path's files, the same set as
    one process, with the same masks."""
    tmp, ranks, _ = world2
    want = one_process["eval"]
    for r, run in enumerate(ranks):
        got = run["eval"]
        _assert_metrics_close(got["metrics"], want["metrics"], f"metrics, rank {r}")
        _assert_metrics_close(got["dense"], want["dense"], f"dense, rank {r}")
        assert [c for c, _, _ in got["ensemble"]] == [c for c, _, _ in want["ensemble"]]
        np.testing.assert_allclose([row[1:] for row in got["ensemble"]],
                                   [row[1:] for row in want["ensemble"]], atol=METRIC_TOL)
    mesh_dir, one_dir = os.path.join(tmp, "dense_mesh"), os.path.join(tmp, "dense_one")
    assert _files(mesh_dir) == _files(one_dir) and len(_files(one_dir)) == 32
    for name in _files(one_dir):
        if name.endswith(".mat"):
            a, b = sio.loadmat(os.path.join(mesh_dir, name)), sio.loadmat(os.path.join(one_dir, name))
            np.testing.assert_array_equal(a["pred_mask"], b["pred_mask"], err_msg=name)


# --- the CLIs under torchrun's variables -------------------------------------------
@pytest.fixture(scope="module")
def clis(tree, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("clis"))
    ranks = workers.Spawned(workers.case_clis, 2, tmp, env=True, root=tree[0], ckpt=tree[1],
                            ports=_free_ports(5))
    one = workers.run_clis(tree[0], tree[1], os.path.join(tmp, "clis_one"))
    return tmp, ranks.join(), one


def test_clis_run_data_parallel(clis):
    """The train (4 sub-steps, validation, saves, summaries),
    test_generator, test_generator_ensemble and pretrain_recover CLIs on 2
    ranks, each starting its process group from torchrun's variables: the
    results are one process's, equal on both ranks, and rank 0 wrote the
    files one process writes (the ensemble's .mat buffers, the saves). The
    train CLI on a (1, 2) mesh (`--mesh_model=2`: rank 1 joins rank 0's
    summary forward) is one process's bit for bit."""
    tmp, ranks, want = clis
    for run in ranks:
        _assert_close_trees(run["train"], want["train"], CLI_RTOL, CLI_ATOL, "train CLI")
        _assert_close_trees(run["train_model_axis"], want["train"], 0, 0, "train CLI, (1, 2)")
        _assert_metrics_close(run["test_generator"], want["test_generator"], "test_generator")
        _assert_close_trees(run["pretrain"], want["pretrain"], RTOL, ATOL, "pretrain CLI")
        for key in ("dataset_iou", "dataset_mae"):
            assert abs(run["ensemble"][key] - want["ensemble"][key]) <= METRIC_TOL, key
        assert run["ensemble"]["frames"] == want["ensemble"]["frames"] == 16
    _assert_equal_ranks([r["train"] for r in ranks], "train CLI across ranks")
    mesh_dir, one_dir = os.path.join(tmp, "clis_mesh"), os.path.join(tmp, "clis_one")
    for sub in ("ensemble", "rec"):
        assert _files(os.path.join(mesh_dir, sub)) == _files(os.path.join(one_dir, sub))
    saves = [f for f in _files(os.path.join(one_dir, "game")) if not f.startswith("events.")]
    assert {"model.best", "model-1"} <= {f.split(os.sep)[0] for f in saves}
    assert [f for f in _files(os.path.join(mesh_dir, "game"))
            if not f.startswith("events.")] == saves


def test_pretrain_flow_refuses_a_world_of_two(clis):
    """PWC pretraining has no mesh in the JAX package (its pretrain_pwc.py
    makes none): under torchrun with 2 ranks the CLI refuses to start."""
    for run in clis[1]:
        assert "not in a world of 2" in run["pretrain_flow"]
        assert "PWC pretraining has no mesh" in run["pretrain_flow"]
