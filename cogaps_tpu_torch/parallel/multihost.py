"""Process start-up, the process mesh, the collectives the sharded engines
share, and per-rank shard checkpoints, on torch.distributed — the
PyTorch counterpart of cogaps_tpu/parallel/multihost.py.

The reference's only distribution mechanism is single-machine
BiocParallel forks (reference: R/DistributedCogaps.R:56-67). Here each
rank is one process: `initialize_distributed` joins the process group,
`global_mesh` describes it, and an engine given that mesh holds a
contiguous group of its units (row blocks, gene shards or chains), as a
JAX mesh assigns units to devices. A run with mesh=None needs no process
group at all: one rank holds every unit, and each collective below is
the local operation on the same (n_units, ...) tensor, so a run's bits
do not depend on the rank count.

Collectives move host tensors under gloo and device tensors under NCCL:
a CUDA tensor given to a gloo collective is copied to the host, the
collective runs there, and the result is copied back to the tensor's
device (PyTorch's gloo backend has no CUDA all_gather). The bits are
moved, never summed, except by the integer sum and the max, which are
exact in any order.

Checkpoints are written per rank, in the JAX package's file layout: each
rank writes what it holds to `<prefix>.shard<rank>.npz`, so no rank ever
gathers the global state; a load reads every rank's file and reassembles
the full arrays.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob
import os
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

ENV_COORDINATOR = "COGAPS_COORDINATOR"
ENV_NUM_PROCESSES = "COGAPS_NUM_PROCESSES"
ENV_PROCESS_ID = "COGAPS_PROCESS_ID"
TIMEOUT = datetime.timedelta(seconds=300)  # a rank that never arrives


class ProcessMesh(NamedTuple):
    """The ranks of one process group along one named axis; the engines
    take it where the JAX package's take a Mesh."""

    axis_name: str
    group: object  # the torch.distributed process group
    size: int
    rank: int
    backend: str


def default_backend(num_processes: int) -> str:
    """NCCL when every rank of this host has a card of its own, gloo when
    the host has no card or fewer cards than ranks (ranks that share a
    card: NCCL refuses two ranks on one GPU)."""
    if torch.cuda.is_available() and (
            torch.cuda.device_count() >= num_processes):
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           messages: bool = False) -> int:
    """Join the process group: of `num_processes` (> 1) ranks at
    `coordinator_address` ("host:port"), else of those that
    COGAPS_COORDINATOR, COGAPS_NUM_PROCESSES and COGAPS_PROCESS_ID name
    (any count, one included), as the JAX package does; with neither it
    is a single process and starts nothing. The backend is `backend`, else
    default_backend(num_processes); under NCCL each rank takes the card
    of its rank. Returns this process's rank. Safe to call again."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    if not (num_processes and num_processes > 1):
        if not os.environ.get(ENV_COORDINATOR):
            return 0
        coordinator_address = os.environ[ENV_COORDINATOR]
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
        process_id = int(os.environ[ENV_PROCESS_ID])
    backend = backend or default_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = ("env://" if coordinator_address is None
            else coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    if messages:
        print(f"rank {process_id} of {num_processes}: torch.distributed "
              f"{backend} at {init}", file=sys.stderr, flush=True)
    return process_id


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def global_mesh(axis_name: str = "chains") -> ProcessMesh:
    """Every rank of the process group along one axis (one rank, and no
    group, in a single process)."""
    if not _initialized():
        return ProcessMesh(axis_name, None, 1, 0, "none")
    return ProcessMesh(axis_name, dist.group.WORLD, dist.get_world_size(),
                       dist.get_rank(), dist.get_backend())


def _distributed(mesh: Optional[ProcessMesh]) -> bool:
    return mesh is not None and mesh.group is not None and mesh.size > 1


def local_units(n_units: int, mesh: Optional[ProcessMesh]) -> range:
    """The contiguous group of n_units / size units this rank holds (all
    of them without a mesh)."""
    if mesh is None:
        return range(n_units)
    if n_units % mesh.size:
        raise ValueError(f"{n_units} units do not split evenly over "
                         f"{mesh.size} ranks")
    per = n_units // mesh.size
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def _staged(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """What a collective of `mesh` operates on: a host copy under gloo."""
    return x.cpu() if mesh.backend == "gloo" else x.contiguous()


def all_gather_units(local: torch.Tensor,
                     mesh: Optional[ProcessMesh]) -> torch.Tensor:
    """Every rank's (units_local, ...) tensor, concatenated in rank order
    (= unit order) into (n_units, ...), on local's device."""
    if not _distributed(mesh):
        return local
    x = _staged(local, mesh)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts).to(local.device)


def ordered_sum(partials, mesh: Optional[ProcessMesh]) -> torch.Tensor:
    """The sum of every unit's partial, added one unit at a time in unit
    order (parallel/sharded.py:170-179 in the JAX package): `partials`
    holds this rank's units in order, a sequence of equal-shaped tensors.
    Never an all_reduce of floats, whose order would follow the rank
    count."""
    if _distributed(mesh):
        partials = all_gather_units(torch.stack(list(partials)), mesh)
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    return total


def _all_reduce(x: torch.Tensor, mesh: Optional[ProcessMesh], op):
    if not _distributed(mesh):
        return x
    y = _staged(x, mesh).clone()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=mesh.group)
    return y.to(x.device)


def sum_ints(x: torch.Tensor, mesh: Optional[ProcessMesh]) -> torch.Tensor:
    """An integer tensor summed over the ranks (exact in any order)."""
    if x.is_floating_point():
        raise TypeError("sum_ints adds integers; floats go through "
                        "ordered_sum")
    return _all_reduce(x, mesh, "SUM")


def max_all(x: torch.Tensor, mesh: Optional[ProcessMesh]) -> torch.Tensor:
    """The elementwise max over the ranks (exact in any order)."""
    return _all_reduce(x, mesh, "MAX")


def barrier(mesh: Optional[ProcessMesh]) -> None:
    if _distributed(mesh):
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group,
                         device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=mesh.group)


# ----------------------------------------------------------------------
# trees: the engines' states are dataclasses (ChainState, RunStats,
# AtomTable) of tensors; a spec is the same tree with each leaf's sharded
# dimension, or None for a replicated leaf
# ----------------------------------------------------------------------
def flatten(tree) -> list:
    """The leaves of a tree of dataclasses, tuples, lists and dicts (keys
    sorted), in field order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in flatten(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in flatten(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    return [tree]


def unflatten(like, leaves) -> object:
    """A tree shaped as `like` with `leaves` in flatten's order."""
    it = iter(leaves)

    def build(t):
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_device(tree, device):
    """A tree of numpy leaves (a checkpoint's) as tensors on `device`."""
    return unflatten(tree, [
        torch.as_tensor(np.ascontiguousarray(x), device=device)
        for x in flatten(tree)])


def local_part(tree, spec, mesh: Optional[ProcessMesh]):
    """The part of each sharded leaf of a full tree that this rank
    holds."""
    out = []
    for leaf, dim in zip(flatten(tree), flatten(spec)):
        if dim is not None and mesh is not None:
            units = local_units(leaf.shape[dim], mesh)
            index = [slice(None)] * np.ndim(leaf)
            index[dim] = slice(units.start, units.stop)
            leaf = leaf[tuple(index)]
        out.append(leaf)
    return unflatten(tree, out)


# ----------------------------------------------------------------------
# per-rank checkpoints: each rank writes only what it holds
# ----------------------------------------------------------------------
def save_sharded_checkpoint(path_prefix: str, tree, extra: dict = None,
                            spec=None,
                            mesh: Optional[ProcessMesh] = None) -> str:
    """Write this rank's part of `tree` to `<prefix>.shard<rank>.npz`
    (through a .tmp file and os.replace): a leaf whose `spec` entry is a
    dimension is this rank's contiguous part of it, stored as
    `leaf{i}_shard<repr of its index's slices>` with the global shape in
    `leaf{i}_shape`; a replicated leaf is `leaf{i}_shard_full`; `extra`
    entries are `extra_*`. Every rank of the mesh waits until all have
    written. Returns the written path."""
    pid = process_index()
    leaves = flatten(tree)
    dims = flatten(spec) if spec is not None else [None] * len(leaves)
    size, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    payload = {"n_leaves": np.int32(len(leaves)),
               "process_id": np.int32(pid),
               "num_processes": np.int32(process_count())}
    for i, (leaf, dim) in enumerate(zip(leaves, dims)):
        arr = _host(leaf)
        if dim is None:
            payload[f"leaf{i}_shard_full"] = arr
            continue
        n = arr.shape[dim]
        index = tuple(slice(rank * n, (rank + 1) * n, None) if j == dim
                      else slice(None, None, None) for j in range(arr.ndim))
        shape = list(arr.shape)
        shape[dim] = n * size
        payload[f"leaf{i}_shard{index!r}"] = arr
        payload[f"leaf{i}_shape"] = np.asarray(shape, np.int64)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = v
    path = f"{path_prefix}.shard{pid}.npz"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    barrier(mesh)
    return path


def shard_files(path_prefix: str) -> list:
    """Every rank's file of a checkpoint, in rank order; refuses a set
    that is not one run's (a file missing, or left by a run of another
    rank count)."""
    files = glob.glob(f"{path_prefix}.shard*.npz")
    if not files:
        raise FileNotFoundError(f"no shard files for {path_prefix}")
    files.sort(key=lambda f: int(f[len(path_prefix) + 6:-4]))
    with np.load(files[0]) as z:
        n = int(z["num_processes"])
    if len(files) != n:
        raise ValueError(f"{path_prefix}: {len(files)} shard files, "
                         f"written by {n} ranks")
    return files


def load_sharded_checkpoint(path_prefix: str, tree_like, spec=None,
                            mesh: Optional[ProcessMesh] = None):
    """Reassemble a tree saved by save_sharded_checkpoint from every
    rank's file, as numpy leaves in the structure of `tree_like`; with
    `spec` and `mesh`, each sharded leaf is cut to this rank's part."""
    zs = [dict(np.load(f)) for f in shard_files(path_prefix)]
    out = []
    for i in range(len(flatten(tree_like))):
        key_full = f"leaf{i}_shard_full"
        if key_full in zs[0]:
            out.append(np.asarray(zs[0][key_full]))
            continue
        shape = tuple(int(x) for x in zs[0][f"leaf{i}_shape"])
        prefix = f"leaf{i}_shard"
        acc = None
        for z in zs:
            for k, v in z.items():
                if k.startswith(prefix):
                    if acc is None:
                        acc = np.zeros(shape, v.dtype)
                    acc[_parse_index(k[len(prefix):], shape)] = v
        out.append(acc)
    full = unflatten(tree_like, out)
    return full if spec is None else local_part(full, spec, mesh)


def _parse_index(idx_str: str, shape) -> tuple:
    """Parse the repr of a shard's index (a tuple of slices) back into
    slices — e.g. '(slice(0, 8, None), slice(None, None, None))'; copied
    from cogaps_tpu/parallel/multihost.py."""
    if idx_str in ("()", "_full"):
        return tuple(slice(None) for _ in shape)
    out = []
    inner = idx_str.strip("()")
    for part in inner.split("slice")[1:]:
        nums = part.strip("(), ").split(",")
        a = None if nums[0].strip() == "None" else int(nums[0])
        b = None if nums[1].strip() == "None" else int(nums[1])
        out.append(slice(a, b))
    while len(out) < len(shape):
        out.append(slice(None))
    return tuple(out)
