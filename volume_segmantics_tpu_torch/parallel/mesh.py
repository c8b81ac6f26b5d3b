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

`get_mesh(n_devices=k)` with k below the world size spans ranks 0..k-1, as
the JAX package's mesh spans its first k devices: a group of those ranks
(`dist.new_group`, which every rank of the world calls, in the same
order), over which ranks 0..k-1 step and evaluate as a world of k would.
A rank at or past k gets a mesh that is not its own (`Mesh.member`
False): every step, batch split and collective on it raises ValueError,
so it never computes on part of the data without a word.

With `space` > 1 the mesh is 2-D, (data, space), laid out as the JAX
package lays out its devices: rank r sits at data row r // space and space
column r % space. A space group (one `dist.new_group` each, created by
every rank in the same order) holds the ranks of one data row, which take
the same rows of the global batch and split image height between them
(`Mesh.band`); `parallel/spatial.py` exchanges the halos of its
convolutions over that group. Every other collective (BatchNorm
statistics, the gathers, the gradient mean, the broadcasts) spans every
rank.
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
    package's ValueError where it does not divide the count."""
    if space > 1 and count % space:
        raise ValueError(f"spatial_partitions={space} must divide the device "
                         f"count ({count}).")


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """The SUM over the ranks of `t`, laid out as `t` is. The collectives
    carry a contiguous buffer; one process's step, which has none, goes on
    with `t` in its own layout, and a later reduction adds in that layout's
    order (on a GPU a convolution bias's gradient, summed over a
    channel-major gradient, came out in other bits than over an NCHW copy),
    so a mesh of one rank keeps the layout to step as one process does."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out if t.is_contiguous() else torch.empty_like(t).copy_(out)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks. Its adjoint is the same sum of the incoming
    gradients: every rank's output feeds its own graph below."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _Place(torch.autograd.Function):
    """This rank's `x` placed at `region` of a tensor of `shape` that the
    ranks fill together (each element held by one rank): a SUM all-reduce
    of a zeroed buffer holding this rank's part (x + 0 is x exactly), the
    collective that NCCL and gloo both carry for CUDA and CPU tensors. Its
    adjoint is a reduce-scatter SUM: this rank's region of the ranks'
    summed gradients."""

    @staticmethod
    def forward(ctx, x, group, shape, region):
        ctx.group, ctx.region = group, region
        out = x.new_zeros(shape)
        out[region] = x
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group)[ctx.region], None, None, None


def band(height: int, parts: int, index: int) -> slice:
    """Rows of a `height` split into `parts` bands, as GSPMD shards an
    axis: every band but the last ones holds ceil(height / parts) rows,
    the last holding rows the remainder leaves it, and bands past the end
    none (3 rows over 2: 2 and 1; 3 over 4: 1, 1, 1 and 0)."""
    per = -(-height // parts)
    return slice(min(index * per, height), min((index + 1) * per, height))


class Mesh:
    """The port's (data, space) mesh: `size` ranks of a process group
    (`group`, None for a process alone), this process being `rank` and
    driving `device`. `space_size` ranks of each data row share its rows of
    the global batch and split image height (`space_group` holds them;
    None at space size 1), so there are `data_size` = size / space_size
    rows of ranks. This rank is at data row `data_index`, space column
    `space_index`. On a rank outside the mesh (`member` False: a mesh over
    the first `size` ranks of a larger world) every step, batch split and
    collective raises ValueError (`check_member`)."""

    def __init__(self, group=None, rank: int = 0, size: int = 1,
                 device=None, space_size: int = 1, space_group=None,
                 member: bool = True):
        self.group = group
        self.rank = rank
        self.size = size
        self.member = member
        self.device = torch.device("cpu" if device is None else device)
        self.space_size = space_size
        self.space_group = space_group
        self.data_size = size // space_size
        self.data_index, self.space_index = divmod(rank, space_size)

    def __deepcopy__(self, memo):
        # A handle on the process group: a copied model shares it.
        return self

    def check_member(self) -> None:
        """ValueError on a rank outside the mesh."""
        if not self.member:
            raise ValueError(
                f"rank {self.rank} is not in this mesh over ranks 0-{self.size - 1} "
                f"(get_mesh(n_devices={self.size})): it takes no part in a "
                "data-parallel step, prediction or collective")

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous rows of a global batch of `n_global`:
        its data row's share."""
        self.check_member()
        if n_global % self.data_size:
            raise ValueError(f"a global batch of {n_global} does not split "
                             f"over {self.data_size} ranks")
        per = n_global // self.data_size
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def band(self, height: int) -> slice:
        """This rank's band of `height` image rows (`band`)."""
        return band(height, self.space_size, self.space_index)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable SUM over the ranks (x itself on a mesh of one)."""
        self.check_member()
        return x if self.group is None else _AllReduceSum.apply(x, self.group)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable global batch of the ranks' `x`: the data rows'
        concatenated along dim 0 and, on a space mesh, the space group's
        bands of rows (`band`) along dim -2, whose global height is x's
        width (the steps' images are square)."""
        self.check_member()
        if self.group is None:
            return x
        n = x.shape[0]
        shape = [self.data_size * n, *x.shape[1:]]
        region = [slice(self.data_index * n, (self.data_index + 1) * n)]
        if self.space_size > 1:
            shape[-2] = x.shape[-1]
            region += [slice(None)] * (x.dim() - 3) + [self.band(x.shape[-1])]
        return _Place.apply(x, self.group, tuple(shape), tuple(region))

    def average_gradients(self, params) -> None:
        """Replace each `.grad` of `params` by its mean over the ranks, in
        one all-reduce of the gradients laid end to end.

        The mean, not the sum: every rank computes the same global loss L
        (its logits and targets are all-gathered) and back-propagates it,
        so the adjoint collectives give the gradient of the sum of the
        ranks' copies, R * L, and the SUM over ranks of the parameters'
        gradients is R * dL/dtheta. (Two gloo ranks on the CPU: 6 where the
        single global loss gives 3.) Dividing by R gives dL/dtheta, the
        gradient of the JAX step's one program. Under space partitioning
        the factor is the same: the halo exchanges (`parallel/spatial.py`)
        only move rows, and their adjoint adds each halo row's gradient
        into the rank that holds the row, once, so a rank's gradients are
        R times what its band and rows contribute to dL/dtheta, as
        before."""
        self.check_member()
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
        self.check_member()
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
    """The mesh over the first `n_devices` ranks of the process group
    (every rank by default; joined here when `VOLSEG_TPU_DISTRIBUTED=1`),
    or over this process alone when there is none: (size / space) data x
    `space` space, `space` dividing the mesh's size (`check_space`).
    `n_devices` at or above the world size is the whole group, as the JAX
    package's `devices[:n_devices]`; below it the mesh is a group of ranks
    0..n_devices-1, which every rank must call `get_mesh` to create, and a
    rank past it gets a mesh it is not a member of (`Mesh.member`).
    `device` (default: the GPU, this rank's under NCCL) is where the rank
    works."""
    maybe_initialize_distributed(device)
    if dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh over {n_devices} devices")
    if n_devices is not None and n_devices < size:
        # Every rank creates every group, in the same order.
        size, made = n_devices, dist.new_group(list(range(n_devices)))
        group = made if rank < size else None
    space = int(space or 1)
    check_space(space, size)
    space_group = None
    if 1 < space < size:
        for row in range(size // space):
            made = dist.new_group(list(range(row * space, (row + 1) * space)))
            if row == rank // space:
                space_group = made
    elif space > 1:
        space_group = group
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, size, dev, space, space_group, member=rank < size)


def space_size(mesh: Mesh) -> int:
    """Size of the spatial-partition axis (1 on a pure data mesh)."""
    return mesh.space_size


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (numpy array or tensor)."""
    return batch[mesh.rows(batch.shape[0])]


def replicate(module_or_tensors, mesh: Mesh):
    """Broadcast rank 0's values into every rank's tensors in place: a
    module's parameters and buffers, or an iterable of tensors. Returns
    its argument."""
    mesh.check_member()
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

