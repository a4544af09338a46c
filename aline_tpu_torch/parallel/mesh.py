"""Process meshes over ``torch.distributed`` (``aline_tpu/parallel/mesh.py``).

One process (rank) drives one device.  A mesh lays the ranks out as JAX
lays out its devices, ``np.arange(n).reshape(shape)``, so rank r sits
where device r sits in the JAX mesh of the same shape, and keeps one
process group per axis: the ranks that differ from this one along that
axis alone.  The axes are those of the JAX package:

* ``data``        — data parallelism over the batch (training: the
                    gradients are all-reduced; evaluation: the bounds'
                    rows);
* ``contrastive`` — the chunks of the L contrastive draws of the
                    sPCE/sNMC bounds, combined by a max-shifted
                    logsumexp (:mod:`aline_tpu_torch.parallel.collectives`);
* ``seq``         — the candidate pool of the greedy eval rollout
                    (:mod:`aline_tpu_torch.eval.traces`).

Without a process group (one process) every mesh has one member and no
group, and every collective is skipped: the same code runs.

``init_distributed`` starts the process group from torchrun's ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``: NCCL with one card a rank on CUDA,
gloo on the CPU.  It never changes device or backend by itself: more
local ranks than visible cards is an error.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aline_tpu_torch.utils.device import resolve_device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world: Optional[int] = None,
                     timeout: Optional[float] = None) -> torch.device:
    """Start this process's rank and return its device.

    ``rank`` and ``world`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; with a world of one (or neither set) no process group
    is started.  ``device="cuda"`` becomes ``cuda:LOCAL_RANK``; an indexed
    CUDA device is kept as given (ranks on gloo may share one card).
    ``backend`` defaults to NCCL on CUDA and gloo on the CPU;
    ``init_method`` to ``env://`` (torchrun's ``MASTER_ADDR`` and
    ``MASTER_PORT``); ``timeout`` is in seconds.
    """
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = int(env.get("WORLD_SIZE", 1)) if world is None else world
    dev = torch.device(device)
    if dev.type == "cuda" and world > 1 and dev.index is None:
        local = int(env.get("LOCAL_RANK", rank))
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(
                f"local rank {local} has no card of its own: {count} CUDA "
                f"device(s) are visible; start at most {count} ranks a "
                f"node, or pass device=cpu for gloo on the CPU")
        dev = torch.device("cuda", local)
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if world > 1 and not dist.is_initialized():
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method or "env://", rank=rank,
            world_size=world, **kw)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks laid out on named axes.

    ``devices`` holds the global ranks in the mesh's shape, as a JAX
    mesh's ``devices`` holds its devices; ``groups[axis]`` is this rank's
    process group along ``axis`` (None where that line has one rank, or
    this rank lies outside the mesh); ``group_all`` spans the mesh."""
    axis_names: Tuple[str, ...]
    devices: np.ndarray
    rank: int
    groups: Dict[str, Optional[object]]
    group_all: Optional[object]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def member(self) -> bool:
        return self.rank < self.size

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        if not self.member:
            raise ValueError(f"rank {self.rank} lies outside the "
                             f"{self.shape} mesh")
        pos = np.unravel_index(self.rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, pos)}

    def index(self, axis: str) -> int:
        return self.coords[axis] if axis in self.shape else 0

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        return self.groups.get(axis)


def _new_group(ranks: Sequence[int]):
    """A process group over ``ranks`` (every rank of the world must call
    it, in the same order), or None for a single rank."""
    if len(ranks) < 2:
        return None
    return dist.new_group([int(r) for r in ranks])


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The mesh of ranks ``0 .. prod(shape) - 1`` laid out in ``shape``.
    Collective: every rank of the world calls it."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    rank = get_rank()
    devices = np.arange(math.prod(shape)).reshape(shape)
    groups = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(devices, ax, -1).reshape(-1, shape[ax])
        groups[name] = None
        for line in lines:
            g = _new_group(line)
            if rank in line:
                groups[name] = g
    # a 1-D mesh's one axis spans it: no second communicator
    group_all = (groups[axis_names[0]] if len(shape) == 1
                 else _new_group(devices.reshape(-1)))
    if rank >= devices.size:
        group_all = None
    return Mesh(axis_names, devices, rank, groups, group_all)


def get_mesh(n_data: int = 0, axis_name: str = "data") -> Mesh:
    """A 1-D mesh over the first ``n_data`` ranks (0: all of them)."""
    n = world_size()
    if n_data <= 0:
        n_data = n
    if n_data > n:
        raise ValueError(f"requested {n_data} shards but only "
                         f"{n} devices are available")
    return make_mesh((n_data,), (axis_name,))


def get_eval_mesh(n_data: int, n_contrastive: int) -> Mesh:
    """The 2-D mesh of the final sPCE/sNMC evaluation: the batch shards
    over ``data``, the L contrastive chunks over ``contrastive``;
    ``n_data * n_contrastive`` ranks take part."""
    n = world_size()
    if n_data * n_contrastive > n:
        raise ValueError(f"requested {n_data}x{n_contrastive} mesh but only "
                         f"{n} devices are available")
    return make_mesh((n_data, n_contrastive), ("data", "contrastive"))


def map_leaves(fn, tree):
    """``fn`` on every tensor and array leaf of a (nested) dict, list,
    tuple or dataclass; other leaves unchanged."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_leaves(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def shard_leading_axis(tree, mesh: Mesh, axis_name: str = "data"):
    """This rank's block of the leading axis of every leaf, as JAX places
    it with ``P(axis_name)``.  Scalars and leaves whose leading axis does
    not divide the axis stay whole (JAX replicates them)."""
    n, i = mesh.axis_size(axis_name), mesh.index(axis_name)

    def _take(x):
        if x.ndim >= 1 and x.shape[0] % n == 0 and x.shape[0] > 0:
            m = x.shape[0] // n
            return x[i * m:(i + 1) * m]
        return x

    return map_leaves(_take, tree)


def pool_bounds(n_pool: int, mesh: Mesh,
                axis_name: str = "seq") -> Tuple[int, int]:
    """[lo, hi): this rank's block of a candidate pool of ``n_pool``
    tokens over ``axis_name``, the block that JAX's ``shard_query_pool``
    places on device r with ``P(None, axis_name)``.  Raises its error if
    the pool does not divide."""
    n = mesh.axis_size(axis_name)
    if n_pool % n:
        # padding the pool would add phantom selectable candidates (the
        # acquisition softmax masks only context/consumed tokens), so the
        # caller must size the pool to the mesh
        raise ValueError(
            f"candidate pool of {n_pool} tokens is not divisible by the "
            f"{n}-way '{axis_name}' mesh axis; choose n_query so that "
            f"n_context_init + n_query is a multiple of {n}")
    m = n_pool // n
    i = mesh.index(axis_name)
    return i * m, (i + 1) * m


def replicate(tree, mesh: Mesh):
    """Every tensor leaf of ``tree`` as the mesh's first rank holds it (a
    broadcast over the mesh, in place)."""
    group = mesh.group_all
    if group is None:
        return tree
    src = int(mesh.devices.reshape(-1)[0])

    def _bcast(x):
        if isinstance(x, torch.Tensor):
            x = x.contiguous()
            dist.broadcast(x, src, group=group)
        return x

    return map_leaves(_bcast, tree)
