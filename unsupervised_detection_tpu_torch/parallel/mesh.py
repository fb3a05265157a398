"""The device mesh over processes, counterpart of
unsupervised_detection_tpu/parallel/mesh.py.

The JAX package runs one process over many devices, shards each batch over
a ("data", "model") mesh and lets XLA insert the collectives. The port runs
one process per device, in a `torch.distributed` process group, and its
steps call the collectives themselves:

  * the ranks form an (n_data, n_model) grid with the data axis the slow
    one: rank = data_index * n_model + model_index, as
    `np.array(devices).reshape(n_data, n_model)`;
  * the data axis splits each global batch into contiguous row blocks
    (`shard`); parameters are replicated. A step scales its local loss so
    that the sum over the data group is the global batch's loss, and
    `sum_data` sum-reduces the gradients (and the logged losses) in one
    flat all_reduce over the data group: the ranks of one model group hold
    the same gradient, so a reduction over every rank would count it
    n_model times. With a model axis the model group then takes its first
    rank's sum (one flat broadcast), so every rank applies the same bits
    even where two processes' backward passes differ in their last bits
    (cuDNN picks its plans by the workspace it can allocate);
  * the model axis splits the PWC cost volume's 2r+1 displacement rows
    (`ops/cost_volume.dy_rows`): each rank of a model group writes its rows
    into a zero-filled volume and `sum_model` sums the group's volumes,
    which is exact (the other ranks contribute LeakyReLU(0) = 0);
  * ranks past n_data * n_model take no batch and join no group of the
    mesh; they wait at the end of the run (`mesh_session`) and exit 0.

Without torchrun's environment (`mesh_from_env`) the mesh is the trivial
(1, 1) one with no process group, and every path is the one-process
program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

# ranks outside the mesh wait this long at the end of a run (a training run
# can take days; NCCL's own barrier would time out after minutes)
_EXIT_TIMEOUT = datetime.timedelta(days=30)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_data, n_model) grid of processes and the
    process groups of its data and model axes. `Mesh()` is the trivial
    mesh: one process, no groups, no collectives. `device` is the device
    this rank computes on (`mesh_from_env`), or None for the caller's."""

    n_data: int = 1
    n_model: int = 1
    data_index: int = 0
    model_index: int = 0
    rank: int = 0                   # global rank; rank 0 prints, saves and restores
    member: bool = True             # False: a rank outside the mesh
    data_group: Any = None          # the ranks with this model index
    model_group: Any = None         # the ranks with this data index
    group: Any = None               # every rank of the mesh
    device: Optional[torch.device] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    # --- the data axis ------------------------------------------------------
    def rows(self, batch_size: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of a global batch."""
        if batch_size % self.n_data:
            raise ValueError(f"batch of {batch_size} does not split over a data axis of "
                             f"{self.n_data}")
        n = batch_size // self.n_data
        return self.data_index * n, (self.data_index + 1) * n

    def batch_rows(self, batch_size: int) -> Optional[tuple[int, int]]:
        """`rows` for a pipeline that decodes only this rank's rows; None
        (the whole batch) on a data axis of one."""
        return self.rows(batch_size) if self.n_data > 1 else None

    def shard(self, x):
        """This rank's rows of `x` (an array, a tensor, or a dict of them)
        along the leading axis; `x` itself on a data axis of one. Ranks of
        one model group take the same rows."""
        if isinstance(x, dict):
            return {k: self.shard(v) for k, v in x.items()}
        if self.n_data == 1:
            return x
        lo, hi = self.rows(x.shape[0])
        return x[lo:hi]

    def sum_data(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Sum `tensors` over the data group, in one all_reduce of a float32
        buffer; each comes back in its own shape and dtype. With a model
        axis the model group then takes its first rank's sum, so every rank
        of the mesh holds the same bits. Without a data group they are
        returned as they are."""
        if self.data_group is None:
            return list(tensors)
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        dist.all_reduce(flat, group=self.data_group)
        if self.n_model > 1:
            dist.broadcast(flat, src=self.data_index * self.n_model, group=self.model_group)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
            i += t.numel()
        return out

    def gather_data(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data group's blocks of `t` along `dim`, concatenated in data
        order: per-sample results in global batch order, on every rank."""
        if self.data_group is None:
            return t
        t = t.contiguous()
        blocks = [torch.empty_like(t) for _ in range(self.n_data)]
        dist.all_gather(blocks, t, group=self.data_group)
        return torch.cat(blocks, dim=dim)

    # --- the model axis -----------------------------------------------------
    def sum_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the model group, in place."""
        if self.n_model > 1:
            dist.all_reduce(t, group=self.model_group)
        return t

    # --- the whole mesh -----------------------------------------------------
    def broadcast(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite `tensors` in place with global rank 0's. CPU tensors
        travel through this rank's device when that is a CUDA device (NCCL
        takes only CUDA tensors)."""
        if self.group is None:
            return
        for t in tensors:
            if self.device is not None and self.device.type == "cuda" and t.device.type == "cpu":
                moved = t.to(self.device)
                dist.broadcast(moved, src=0, group=self.group)
                t.copy_(moved.cpu())
            else:
                dist.broadcast(t, src=0, group=self.group)


def world() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, else of
    torchrun's environment, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              batch_size: Optional[int] = None, device=None) -> Mesh:
    """The (n_data, n_model) mesh over the initialized process group's ranks
    (one rank without a group), with JAX's semantics:

      * n_data defaults to world // n_model;
      * with `batch_size` and no explicit n_data, the data axis shrinks to
        the largest divisor of the batch (JAX's WARNING, printed by rank 0);
      * an explicit n_data that does not divide `batch_size` raises.

    Every rank of the world must call it: it creates the groups collectively.
    Ranks past n_data * n_model get a mesh with `member` False."""
    initialized = dist.is_available() and dist.is_initialized()
    rank, world_size = (dist.get_rank(), dist.get_world_size()) if initialized else (0, 1)
    explicit = n_data is not None
    if n_data is None:
        n_data = world_size // n_model
    if batch_size is not None and not explicit:
        requested = n_data
        while n_data > 1 and batch_size % n_data != 0:
            n_data -= 1
        if n_data != requested and rank == 0:
            print("WARNING: batch_size=%d does not split over %d devices; "
                  "using a %d-device data axis (%d devices idle). Pick a "
                  "batch divisible by the device count for full utilization."
                  % (batch_size, requested, n_data, (requested - n_data) * n_model))
    if explicit and batch_size is not None and batch_size % n_data != 0:
        raise ValueError(f"mesh_data={n_data} does not divide batch_size={batch_size}")
    if n_data < 1 or n_model < 1 or n_data * n_model > world_size:
        raise ValueError(f"a ({n_data}, {n_model}) mesh does not fit {world_size} "
                         f"process(es)")
    size = n_data * n_model
    if not initialized:
        return Mesh(device=device)
    # every rank creates every group, in the same order
    group = dist.new_group(list(range(size)))
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    if rank >= size:
        return Mesh(n_data, n_model, rank=rank, member=False, device=device)
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, d, m, rank=rank, data_group=data_groups[m],
                model_group=model_groups[d], group=group, device=device)


def mesh_from_env(n_data: Optional[int] = None, n_model: int = 1,
                  batch_size: Optional[int] = None, device=None,
                  backend: Optional[str] = None) -> Mesh:
    """The mesh of a run under torchrun: reads RANK, WORLD_SIZE and
    LOCAL_RANK, initializes the default process group from torchrun's
    store (MASTER_ADDR, MASTER_PORT) and calls `make_mesh`. This rank's
    device is cuda:LOCAL_RANK unless `device` names the CPU; the backend
    is NCCL on CUDA and gloo on the CPU, unless `backend` names one (gloo
    for ranks that share one card, which NCCL refuses). An NCCL failure
    raises: nothing falls back to gloo or the CPU.

    Without torchrun's variables: the trivial mesh, no process group, and
    `device` as given (None: the card, resolved by the entry point); a mesh
    of several processes asked for there raises SystemExit, as JAX cannot
    make it from one device either."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        if (n_data or 1) * n_model > 1:
            raise SystemExit(
                f"--mesh_data={n_data or 0} --mesh_model={n_model} ask for a mesh of several "
                "processes, but this run has no mesh: it was not started by torchrun "
                "(torchrun --nproc_per_node=N -m ...)")
        return Mesh(device=None if device is None else torch.device(device))
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if device is None or torch.device(device).type == "cuda":
        dev = resolve_device(f"cuda:{local_rank}")
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size)
    return make_mesh(n_data, n_model, batch_size, device=dev)


@contextlib.contextmanager
def mesh_session(config, device=None):
    """A CLI's run on the mesh of `config` (mesh_data, mesh_model,
    batch_size) under torchrun, or on the trivial mesh without it. On a
    clean exit every rank of the world meets at a gloo barrier (ranks
    outside the mesh wait there for the run) and the process group is
    destroyed; after an error it is destroyed without the barrier."""
    started = dist.is_available() and not dist.is_initialized()
    mesh = mesh_from_env(config.mesh_data or None, config.mesh_model, config.batch_size,
                         device=device)
    started = started and dist.is_initialized()
    exit_group = dist.new_group(backend="gloo", timeout=_EXIT_TIMEOUT) if started else None
    ok = False
    try:
        yield mesh
        ok = True
    finally:
        if started:
            if ok:
                dist.barrier(group=exit_group)
            dist.destroy_process_group()
