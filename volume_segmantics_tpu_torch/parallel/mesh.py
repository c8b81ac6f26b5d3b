"""Process groups and the data mesh for data-parallel training and
prediction (port of the JAX package's `parallel/mesh.py`).

The JAX package builds one program over a mesh of every device, and GSPMD
inserts the collectives. The port runs one process a GPU, a "rank" of a
`torch.distributed` process group (NCCL between GPUs, gloo on the CPU or
through the host). Every rank holds a replica of the parameters and takes
its contiguous rows of each global batch; the collectives are explicit and
go through `Mesh`: all-reduce SUM, an all-gather along the batch, a
broadcast from rank 0 and the gradient average. The first two are
`torch.autograd.Function`s of this module, each backward the adjoint of
its forward (an all-reduce SUM of the incoming gradients; a reduce-scatter
SUM), so a graph built from them differentiates like the one program over
the global batch that the JAX step is (see `Mesh.average_gradients` for
the factor this leaves).

A process with no group is a mesh of one: rank 0 of 1, no collective.
Spatial partitioning (the `space` axis, halo-exchanging convolutions) is
not ported; `get_mesh(space > 1)` refuses it by name.
"""

import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from volume_segmantics_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
SPACE_AXIS = "space"
DISTRIBUTED_ENV = "VOLSEG_TPU_DISTRIBUTED"
# The JAX runtime's variables, then torchrun's.
JAX_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def maybe_initialize_distributed(device=None) -> bool:
    """Join a process group when `VOLSEG_TPU_DISTRIBUTED=1`; returns True
    when the process is one of several ranks. A default group that is
    already initialised is used as it is.

    The cluster is read from the JAX runtime's JAX_COORDINATOR_ADDRESS
    (host:port), JAX_NUM_PROCESSES and JAX_PROCESS_ID, or else from
    torchrun's MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE. A rank drives
    the GPU LOCAL_RANK (default: its rank modulo the GPUs), over NCCL; with
    `device="cpu"` the group is gloo."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    flag = os.environ.get(DISTRIBUTED_ENV, "0").lower()
    if flag not in ("1", "true", "yes"):
        return False
    env = os.environ
    if all(env.get(k) for k in JAX_ENV):
        init_method = f"tcp://{env['JAX_COORDINATOR_ADDRESS']}"
        world, rank = int(env["JAX_NUM_PROCESSES"]), int(env["JAX_PROCESS_ID"])
    elif all(env.get(k) for k in TORCHRUN_ENV):
        init_method = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        raise RuntimeError(
            f"{DISTRIBUTED_ENV}=1 needs {', '.join(JAX_ENV)} or torchrun's "
            f"{', '.join(TORCHRUN_ENV)}.")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    logging.info(f"Process group up ({backend}): rank {rank} of {world}.")
    return world > 1


def check_space(space: int, count: int) -> None:
    """`spatial_partitions` against the mesh's device count: the JAX
    package's ValueError where it does not divide the count; above 1 it
    asks for spatial partitioning, which is not ported."""
    if space <= 1:
        return
    if count % space:
        raise ValueError(f"spatial_partitions={space} must divide the device "
                         f"count ({count}).")
    raise NotImplementedError(
        f"spatial_partitions={space} splits image height over {space} "
        "devices; spatial partitioning (halo-exchanging convolutions on a "
        f"'{SPACE_AXIS}' mesh axis) is not ported yet (ROADMAP.md, section 1 "
        "item 1).")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks. Its adjoint is the same sum of the incoming
    gradients: every rank's output feeds its own graph below."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """The ranks' (n, ...) tensors stacked along the batch, rank order. It
    is a SUM all-reduce of a zeroed (size * n, ...) buffer holding this
    rank's rows (x + 0 is x exactly), the collective that NCCL and gloo
    both carry for CUDA and CPU tensors. Its adjoint is a reduce-scatter
    SUM: this rank's rows of the ranks' summed gradients."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rows = group, slice(rank * x.shape[0],
                                           (rank + 1) * x.shape[0])
        out = x.new_zeros((size * x.shape[0], *x.shape[1:]))
        out[ctx.rows] = x
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out[ctx.rows], None, None, None


class Mesh:
    """The `DATA_AXIS` of the port's mesh: `size` ranks of a process group
    (`group`, None for a process alone), this process being `rank` and
    driving `device`."""

    def __init__(self, group=None, rank: int = 0, size: int = 1,
                 device=None):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = torch.device("cpu" if device is None else device)

    def __deepcopy__(self, memo):
        # A handle on the process group: a copied model shares it.
        return self

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous rows of a global batch of `n_global`."""
        if n_global % self.size:
            raise ValueError(f"a global batch of {n_global} does not split "
                             f"over {self.size} ranks")
        per = n_global // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable SUM over the ranks (x itself on a mesh of one)."""
        return x if self.group is None else _AllReduceSum.apply(x, self.group)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable concatenation of the ranks' `x` along dim 0."""
        if self.group is None:
            return x
        return _AllGather.apply(x, self.group, self.rank, self.size)

    def average_gradients(self, params) -> None:
        """Replace each `.grad` of `params` by its mean over the ranks, in
        one all-reduce of the gradients laid end to end.

        The mean, not the sum: every rank computes the same global loss L
        (its logits and targets are all-gathered) and back-propagates it,
        so the adjoint collectives give the gradient of the sum of the
        ranks' copies, R * L, and the SUM over ranks of the parameters'
        gradients is R * dL/dtheta. (Two gloo ranks on the CPU: 6 where the
        single global loss gives 3.) Dividing by R gives dL/dtheta, the
        gradient of the JAX step's one program."""
        if self.group is None:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.size)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def broadcast_object(self, obj):
        """Rank 0's `obj` (any picklable object) on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self._object_device())
        return box[0]

    def _object_device(self):
        """Where `broadcast_object_list` stages its bytes: the GPU for
        NCCL, the CPU for gloo."""
        if dist.get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")


def get_mesh(n_devices: Optional[int] = None, space: int = 1,
             device=None) -> Mesh:
    """The data mesh over every rank of the process group (joined here when
    `VOLSEG_TPU_DISTRIBUTED=1`), or over this process alone when there is
    none. `n_devices` below the world size (a mesh over some of the ranks)
    is not ported; `space` > 1 raises as `check_space` says. `device`
    (default: the GPU, this rank's under NCCL) is where the rank works."""
    maybe_initialize_distributed(device)
    if dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if n_devices is not None and n_devices < size:
        raise NotImplementedError(
            f"a mesh over {n_devices} of the group's {size} ranks is not "
            "ported: the data mesh spans the whole group.")
    check_space(int(space or 1), size)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, size, dev)


def space_size(mesh: Mesh) -> int:
    """Size of the spatial-partition axis: 1, the only size ported."""
    return 1


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (numpy array or tensor)."""
    return batch[mesh.rows(batch.shape[0])]


def replicate(module_or_tensors, mesh: Mesh):
    """Broadcast rank 0's values into every rank's tensors in place: a
    module's parameters and buffers, or an iterable of tensors. Returns
    its argument."""
    if mesh.group is None:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = list(module_or_tensors.state_dict().values())
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=mesh.group)
    return module_or_tensors


# ----------------------------------------------------------------------
# Ranks in child processes
# ----------------------------------------------------------------------


def _rank_entry(rank, fn, world_size, backend, init_method, args):
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args=(), backend="gloo",
                timeout: Optional[float] = None) -> None:
    """Run `fn(rank, *args)` in `world_size` new processes, each rank of a
    fresh process group (`backend`; under NCCL rank r drives GPU r), met
    through a file in a temporary directory. Returns when every rank has
    returned. A rank that raises or dies ends the others and raises here;
    past `timeout` seconds every rank is killed and TimeoutError raised.
    `fn` must be importable by name (a module-level function)."""
    with tempfile.TemporaryDirectory(prefix="volseg_ranks_") as tmp:
        init_method = Path(tmp, "rendezvous").as_uri()
        ctx = mp.start_processes(
            _rank_entry, args=(fn, world_size, backend, init_method, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"{world_size} ranks of {fn.__name__} did not end within "
                    f"{timeout} s")

