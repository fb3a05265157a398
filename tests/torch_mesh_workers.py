"""Rank workers of tests/test_torch_mesh.py: the port on a multi-process
mesh on the CPU (gloo), and the same calls in one process for the tests to
compare.

This module imports neither JAX nor the JAX package, and no conftest: the
spawned ranks import only it and the port. Every `run_*` function takes a
`Mesh` (the trivial one for the one-process side) and returns plain tensors
and numbers; `Spawned` runs a `case_*` function on every rank of a gloo world
and returns what each rank returned.

Sizes: reader 64x128, working 32x64, PWC 6 levels r=2, global batch 4.
"""

from __future__ import annotations

import contextlib
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from unsupervised_detection_tpu_torch import Config
from unsupervised_detection_tpu_torch.convert import (
    from_jax_params, random_jax_params, random_recover_params, recover_state_dict)
from unsupervised_detection_tpu_torch.eval import EnsembleEvaluator, Evaluator, evaluate_dataset
from unsupervised_detection_tpu_torch.eval.ensemble import crop_metrics
from unsupervised_detection_tpu_torch.eval.evaluator import build_test_pipeline
from unsupervised_detection_tpu_torch.models import GeneratorNet, PWCNet, RecoverNet
from unsupervised_detection_tpu_torch.ops.augment import sample_augment
from unsupervised_detection_tpu_torch.ops.cost_volume import cost_volume_forward, dy_rows
from unsupervised_detection_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_from_env
from unsupervised_detection_tpu_torch.train.checkpoint import (
    load_eval_checkpoint, save_eval_checkpoint)
from unsupervised_detection_tpu_torch.train.learner import AdversarialLearner
from unsupervised_detection_tpu_torch.train.pretrain import RecoverPretrainer

B = 4
SIZES = dict(batch_size=B, reader_height=64, reader_width=128, img_height=32, img_width=64,
             pwc_search_range=2, num_threads=1)
CV_SHAPE = (2, 6, 10, 24)     # (B, H, W, C) of the model-axis cost volume cases


# --- inputs -------------------------------------------------------------------
def weights(seed: int = 21):
    """(gen_params, gen_stats, rec_params, pwc_params) in the flax layout; the
    generator's head x 30 so the mask spans [0, 1] and keeps its gradients."""
    gen_p, gen_s, pwc_p = random_jax_params(GeneratorNet(), PWCNet(search_range=2), seed=seed)
    gen_p["conv17"]["conv"]["kernel"] = gen_p["conv17"]["conv"]["kernel"] * 30.0
    return gen_p, gen_s, random_recover_params(RecoverNet(), seed=seed + 1), pwc_p


def write_checkpoint(path: str) -> str:
    gen_p, gen_s, _, pwc_p = weights()
    return save_eval_checkpoint(path, gen_p, gen_s, pwc_p)


def frames(seed: int = 23):
    """(img1, img2, gt) of the global batch: float32 tensors at the reader
    size, a textured square moving over a textured background."""
    rs = np.random.RandomState(seed)
    h, w = SIZES["reader_height"], SIZES["reader_width"]
    bg = rs.rand(B, h + 8, w + 8, 3).astype(np.float32) - 0.5
    img1, img2 = bg[:, 4:h + 4, 4:w + 4].copy(), bg[:, 2:h + 2, 1:w + 1].copy()
    fg = rs.rand(B, 16, 16, 3).astype(np.float32) - 0.5
    img1[:, 20:36, 40:56] = fg
    img2[:, 22:38, 43:59] = fg
    gt = np.zeros((B, h, w, 1), np.float32)
    gt[:, 20:36, 40:56] = 1.0
    return tuple(torch.from_numpy(a) for a in (img1, img2, gt))


def cost_volume_inputs(dtype=torch.float32):
    rs = np.random.RandomState(5)
    return tuple(torch.from_numpy(rs.randn(*CV_SHAPE).astype(np.float32)).to(dtype)
                 for _ in range(2))


def make_learner(config: Config, mesh: Mesh):
    learner = AdversarialLearner(config, "cpu", mesh)
    gen_p, gen_s, rec_p, pwc_p = weights()
    learner.objective.load_state_dicts(*from_jax_params(gen_p, gen_s, pwc_p))
    learner.objective.recover.load_state_dict(recover_state_dict(rec_p))
    return learner, learner.init_state()


def params(state) -> dict:
    return {f"{net}.{k}": v.detach().clone() for net, m in
            (("gen", state.generator), ("rec", state.recover)) for k, v in m.named_parameters()}


# --- the calls, on any mesh ---------------------------------------------------
def run_steps(mesh: Mesh) -> dict:
    """One generator step and one recover step from the same weights and
    global augmentation draws, then `val_step`: the losses (the global
    batch's), the applied gradients and the parameters after both."""
    learner, state = make_learner(Config(**SIZES), mesh)
    img1, img2, gt = (mesh.shard(t) for t in frames())
    gen = torch.Generator().manual_seed(5)
    out = {}
    for name in ("generator_step", "recover_step"):
        draws = sample_augment(gen, B, SIZES["reader_height"], SIZES["reader_width"], 0.9)
        state, losses, grads = getattr(learner, name)(state, img1, img2, draws=draws)
        out[name] = {"losses": {k: float(v) for k, v in losses.items()},
                     "grads": [g.clone() for g in grads]}
    out["params"] = params(state)
    out["val"] = float(learner.val_step(state, img1, img2, gt))
    return out


def run_noise(mesh: Mesh) -> dict:
    """A generator step whose noise test always fires (threshold 1e9), its
    draws taken from `state.rng`: the applied gradients are the noise."""
    learner, state = make_learner(Config(**SIZES, grad_noise_threshold=1e9), mesh)
    img1, img2, _ = (mesh.shard(t) for t in frames())
    state, _, grads = learner.generator_step(state, img1, img2)
    return {"grads": [g.clone() for g in grads], "params": params(state),
            "rng": state.rng.get_state()}


def run_pretrain(mesh: Mesh) -> dict:
    """One `RecoverPretrainer.step` (its box draws from the trainer's rng)."""
    trainer = RecoverPretrainer(Config(**SIZES), "cpu", mesh)
    img1, img2, _ = (mesh.shard(t) for t in frames())
    loss = trainer.step(img1, img2)
    return {"loss": float(loss),
            "params": {k: v.detach().clone() for k, v in trainer.recover.named_parameters()}}


def run_eval(mesh: Mesh, root: str, ckpt: str, dense_dir: str) -> dict:
    """`evaluate_dataset` on the tree's trainval frames (a wrapped last
    batch), metrics-only and dense (files under `dense_dir`), and the
    4-crop ensemble's per-frame crop means over the same stream."""
    cfg = Config(**SIZES, root_dir=root, test_partition="trainval")
    ev = Evaluator(cfg, "cpu", mesh)
    ev.load_state_dicts(*load_eval_checkpoint(ckpt, 2))
    out = {"metrics": evaluate_dataset(cfg, ev, verbose=False),
           "dense": evaluate_dataset(cfg, ev, save_dir=dense_dir, generate_visualization=True,
                                     verbose=False)}
    ens = EnsembleEvaluator(cfg, "cpu", mesh)
    ens.load_state_dicts(*load_eval_checkpoint(ckpt, 2))
    rows = []
    for batch in build_test_pipeline(cfg, mesh):
        res = ens.run(batch)
        for b in range(res["pred_masks"].shape[1]):
            ious, maes, _ = crop_metrics(res, b)
            rows.append((batch["category"][b], float(np.mean(ious)), float(np.mean(maes))))
    out["ensemble"] = rows
    return out


def run_model_axis(mesh: Mesh) -> dict:
    """The cost volume split over the model group (each rank's dy rows,
    summed over the group) in both dtypes, and the Evaluator's masks."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        c1, warp = cost_volume_inputs(dtype)
        rows = dy_rows(2, mesh.n_model, mesh.model_index)
        out[str(dtype)] = {"rows": rows, "volume": mesh.sum_model(
            cost_volume_forward(c1, warp, 2, dy_range=rows))}
    ev = Evaluator(Config(**SIZES), "cpu", mesh)
    gen_p, gen_s, _, pwc_p = weights()
    ev.load_state_dicts(*from_jax_params(gen_p, gen_s, pwc_p))
    out["mask"] = ev.infer(*(mesh.shard(t) for t in frames()))["gen_masks"]
    return out


# --- the spawned worlds -------------------------------------------------------
class Spawned:
    """`case(rank, world, tmp, **kw)` running on `world` spawned ranks, each
    with one torch thread; `join()` waits for them and returns each rank's
    return value. Without `env` the ranks join a gloo group over a
    FileStore in `tmp`; with it they get torchrun's variables (MASTER_ADDR
    localhost) and `case` starts the group itself, as the CLIs do. The
    caller computes its one-process side while the ranks run."""

    def __init__(self, case, world: int, tmp: str, env: bool = False, **kw):
        self.name, self.world, self.tmp = case.__name__, world, tmp
        self.context = mp.spawn(_entry, args=(self.name, world, tmp, env, kw), nprocs=world,
                                join=False)

    def join(self, timeout: float = 600.0) -> list:
        """Each rank's return value; raises if a rank failed, and stops the
        ranks and raises TimeoutError after `timeout` seconds."""
        deadline = time.monotonic() + timeout
        while not self.context.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for proc in self.context.processes:
                    proc.terminate()
                raise TimeoutError(f"{self.name}: ranks still running after {timeout} s")
        return [torch.load(os.path.join(self.tmp, f"{self.name}_{r}.pt"), weights_only=False)
                for r in range(self.world)]


def _entry(rank: int, name: str, world: int, tmp: str, env: bool, kw) -> None:
    torch.set_num_threads(1)
    if env:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="localhost")
    else:
        store = dist.FileStore(os.path.join(tmp, f"{name}.store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = globals()[name](rank, world, tmp, **kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"{name}_{rank}.pt"))


def case_mesh_semantics(rank: int, world: int, tmp: str) -> dict:
    """make_mesh on 3 ranks: the defaults, the shrink at batch 4 (rank 0's
    console), an explicit n_data that does not divide the batch; then the
    model axis on all 3 ranks (r=2: rows 2, 2, 1)."""
    out = {}
    mesh = make_mesh()
    out["default"] = (mesh.n_data, mesh.n_model, mesh.data_index, mesh.member)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        mesh = make_mesh(batch_size=4)
    out["shrink"] = (mesh.n_data, mesh.n_model, mesh.data_index, mesh.member,
                     mesh.rows(4) if mesh.member else None, text.getvalue())
    try:
        make_mesh(n_data=3, batch_size=4)
    except ValueError as err:
        out["error"] = str(err)
    out["model_axis"] = run_model_axis(make_mesh(n_data=1, n_model=3))
    return out


def case_world2(rank: int, world: int, tmp: str, root: str, ckpt: str) -> dict:
    """On 2 ranks: the (2,1) steps, noise, recover pretraining step and
    evaluation; the (1,2) model axis."""
    mesh = make_mesh(batch_size=B)
    return {"mesh": (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index),
            "steps": run_steps(mesh), "noise": run_noise(mesh), "pretrain": run_pretrain(mesh),
            "eval": run_eval(mesh, root, ckpt, os.path.join(tmp, "dense_mesh")),
            "model_axis": run_model_axis(make_mesh(n_data=1, n_model=2))}


def case_world4(rank: int, world: int, tmp: str) -> dict:
    """On 4 ranks: the (2,2) steps (the model axis splits PWC's cost
    volume inside them)."""
    mesh = make_mesh(n_model=2, batch_size=B)
    return {"mesh": (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index),
            "steps": run_steps(mesh)}


def case_env_backend(rank: int, world: int, tmp: str, port: int) -> dict:
    """mesh_from_env on 2 ranks under torchrun's variables with the backend
    named, as a rank sharing one card names gloo: a (1, 2) mesh, and
    `sum_data` of a tensor that differs by rank (the model group takes its
    first rank's sum)."""
    os.environ["MASTER_PORT"] = str(port)
    mesh = mesh_from_env(n_data=1, n_model=2, device="cpu", backend="gloo")
    got = mesh.sum_data([torch.full((3,), 1.0 + rank), torch.tensor(rank)])
    return {"backend": dist.get_backend(), "mesh": (mesh.n_data, mesh.n_model, mesh.data_index,
                                                    mesh.model_index, str(mesh.device)),
            "sum": got}


def cli_flags(root: str, ckpt: str) -> list:
    return [f"--root_dir={root}", f"--ckpt_file={ckpt}", f"--flow_ckpt={ckpt}",
            "--pwc_search_range=2", "--reader_height=64", "--reader_width=128",
            "--img_height=32", "--img_width=64", f"--batch_size={B}", "--num_threads=1"]


def run_clis(root: str, ckpt: str, out_dir: str, ports=None) -> dict:
    """The train, test_generator, test_generator_ensemble and
    pretrain_recover CLIs, into `out_dir`; returns what they return, as
    plain values. Under torchrun's variables each CLI's process group takes
    the next of `ports`, and the train CLI runs a second time on a model
    axis (`--mesh_model=2`)."""
    port_list = iter(ports or ())

    def next_port():
        port = next(port_list, None)
        if port is not None:
            os.environ["MASTER_PORT"] = str(port)

    import importlib

    from unsupervised_detection_tpu_torch import (
        pretrain_recover, test_generator, test_generator_ensemble)

    train_cli = importlib.import_module("unsupervised_detection_tpu_torch.train.__main__")
    flags = cli_flags(root, ckpt)
    out = {}
    next_port()
    train_flags = ["--num_samples_train=16", "--max_epochs=1", "--summary_freq=4",
                   "--save_freq=1"]
    state = train_cli.main(flags + train_flags + [f"--checkpoint_dir={out_dir}/game"],
                           device="cpu")
    out["train"] = None if state is None else params(state)
    if ports is not None:
        next_port()
        state = train_cli.main(flags + train_flags + [f"--checkpoint_dir={out_dir}/game_model",
                                                      "--mesh_model=2"], device="cpu")
        out["train_model_axis"] = params(state)
    next_port()
    out["test_generator"] = test_generator.main(flags + ["--test_partition=trainval"],
                                                device="cpu")
    next_port()
    out["ensemble"] = test_generator_ensemble.main(
        flags + ["--test_partition=trainval", "--generate_visualization",
                 f"--test_save_dir={out_dir}/ensemble"], device="cpu")
    next_port()
    rec = pretrain_recover.main(flags + ["--pretrain_steps=1", f"--checkpoint_dir={out_dir}/rec"],
                                device="cpu")
    out["pretrain"] = None if rec is None else {k: v.detach().clone()
                                                for k, v in rec.named_parameters()}
    return out


def case_clis(rank: int, world: int, tmp: str, root: str, ckpt: str, ports) -> dict:
    """The CLIs under torchrun's variables on 2 ranks (each CLI starts and
    ends the process group), then pretrain_flow's refusal."""
    from unsupervised_detection_tpu_torch import pretrain_flow

    out = run_clis(root, ckpt, os.path.join(tmp, "clis_mesh"), ports)
    try:
        pretrain_flow.main(["--pretrain_steps=1", "--batch_size=2", "--reader_height=64",
                            "--reader_width=64", "--pwc_search_range=2"], device="cpu")
    except SystemExit as err:
        out["pretrain_flow"] = str(err)
    return out
