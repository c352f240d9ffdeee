"""Device mesh, parameter layouts and the collectives that carry them (the
port of ``whisperseg_tpu/parallel/mesh.py``).

A :class:`Mesh` is a (dp, tp) grid of ``torch.device``s with the axes
``("data", "model")``. :func:`param_pspecs` gives each parameter leaf its
per-axis spec, a tuple with ``"data"``, ``"model"`` or None for each dim,
the same tree the JAX package's ``PartitionSpec``s make:

  * data parallelism ("data"): the batch split by rows, gradients summed;
  * tensor parallelism ("model", ``tp``): Megatron's split, q/k/v/fc1 (and
    the cross-attention's xq/xk/xv) by column, o/fc2/xo by row;
  * ``fsdp``: every other leaf of two or more dims split over "data" on its
    largest dim that ``data_size`` divides, all-gathered before use.

The JAX package leaves the collectives to XLA's GSPMD. Here they are
written out: the model runs one process per device, and
:func:`shard_params` cuts each rank's part of each leaf. In a
tensor-parallel forward (:func:`model_parallel`) a column-parallel
projection's input goes through :func:`copy_to_model` (identity forward,
gradient summed over the model axis) and a row-parallel product's output
through :func:`reduce_from_model` (summed over the model axis, identity
backward), Megatron's f and g; the bias is added once, after the sum.
:func:`gather_shard` all-gathers an fsdp leaf and reduce-scatters its
gradient. Over gloo, collectives on CUDA tensors are staged through host
memory (gloo's own CUDA support is partial); NCCL runs them on the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import WhisperConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A (dp, tp) grid of devices with the axes ("data", "model"). Rank r of
    a process group drives ``devices.flat[r]``: data index ``r // tp``,
    model index ``r % tp``."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        dp, tp = self.devices.shape
        return {DATA_AXIS: dp, MODEL_AXIS: tp}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int):
        """(data index, model index) of ``rank``."""
        return divmod(rank, self.shape[MODEL_AXIS])

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


class Sharding(NamedTuple):
    """A per-axis spec on a mesh (``()`` is replicated)."""

    mesh: Mesh
    spec: tuple


def make_mesh(num_devices: Optional[int] = None, tp: int = 1,
              devices=None) -> Mesh:
    """A (dp, tp) mesh over ``devices`` (default: every CUDA device; a CPU
    mesh is asked for by passing CPU devices)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=[torch.device("
                               "'cpu'), ...] for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if num_devices is not None:
        devices = devices[:num_devices]
    n = len(devices)
    if n == 0 or n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // tp, tp))


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading (batch) dim split over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


_COLUMN = ("q_w", "k_w", "v_w", "fc1_w", "xq_w", "xk_w", "xv_w")
_ROW = ("o_w", "fc2_w", "xo_w")
_COLUMN_BIAS = ("q_b", "v_b", "fc1_b", "xq_b", "xv_b")


def param_pspecs(params, cfg: WhisperConfig, tp: bool = False,
                 fsdp: bool = False, data_size: int = 0):
    """The tree of per-axis specs for the parameter tree. ``data_size``
    (the data axis's extent, when known) keeps fsdp to dims it divides; a
    leaf with no such dim stays replicated."""
    def spec_for(path: str, leaf) -> tuple:
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if tp:
            name = path.split(".")[-1]
            if name in _COLUMN or name in _COLUMN_BIAS:
                return (None,) * (ndim - 1) + (MODEL_AXIS,)
            if name in _ROW:
                return (None,) * (ndim - 2) + (MODEL_AXIS, None)
        if fsdp and ndim >= 2:
            # the largest data_size-divisible dim, in numpy's argsort order
            for axis in np.argsort(shape)[::-1]:
                if data_size <= 1 or shape[axis] % data_size == 0:
                    spec = [None] * ndim
                    spec[int(axis)] = DATA_AXIS
                    return tuple(spec)
        return ()

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in tree.items()}
        return spec_for(prefix, tree)

    return walk(params)


def param_shardings(mesh: Mesh, params, cfg: WhisperConfig, tp: bool = False,
                    fsdp: bool = False):
    specs = param_pspecs(params, cfg, tp=tp, fsdp=fsdp,
                         data_size=mesh.shape[DATA_AXIS])
    return tree_map(specs, lambda s: Sharding(mesh, s))


def tree_map(tree, fn, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def mesh_rank(mesh: Mesh) -> int:
    """This process's rank on ``mesh``: its rank in the default process
    group, whose size must be the mesh's; 0 without a group on a mesh of
    one device."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != mesh.size:
            raise ValueError(f"a mesh of {mesh.size} devices needs a process "
                             f"group of {mesh.size} ranks, not {world}")
        return dist.get_rank()
    if mesh.size != 1:
        raise ValueError(f"a mesh of {mesh.size} devices needs a process group "
                         f"of {mesh.size} ranks (multihost.initialize, or "
                         f"run_training with n_device)")
    return 0


def local_part(leaf: torch.Tensor, spec: tuple, mesh: Mesh,
               rank: int) -> torch.Tensor:
    """The part of ``leaf`` that ``rank`` holds under ``spec``."""
    coords = dict(zip(mesh.axis_names, mesh.coords(rank)))
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.shape[axis], coords[axis]
        if leaf.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(leaf.shape)} leaf does not "
                             f"divide over the {n}-way {axis!r} axis")
        size = leaf.shape[dim] // n
        leaf = leaf.narrow(dim, i * size, size)
    return leaf


def shard_params(mesh: Mesh, params, cfg: WhisperConfig, tp: bool = False,
                 fsdp: bool = False):
    """This rank's part of every leaf under the chosen layout, on its
    device (``mesh.devices.flat[rank]``)."""
    rank = mesh_rank(mesh)
    device = mesh.devices.flat[rank]
    specs = param_pspecs(params, cfg, tp=tp, fsdp=fsdp,
                         data_size=mesh.shape[DATA_AXIS])
    return tree_map(params, lambda leaf, spec: local_part(
        leaf, spec, mesh, rank).to(device).contiguous(), specs)


# ------------------------------------------------------------- collectives


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (a new tensor; ``t`` itself for a group
    of None, one rank)."""
    if group is None:
        return t
    if _staged(group) and t.is_cuda:
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The parts of ``group``'s ranks concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    if _staged(group) and t.is_cuda:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device).movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part, along ``dim``, of the sum of ``t`` over ``group``
    (over gloo: the sum of an all-reduce, cut)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    src = t.detach().movedim(dim, 0).contiguous()
    size = src.shape[0] // n
    if _staged(group):
        out = all_reduce(src, group).narrow(0, i * size, size)
    else:
        out = src.new_empty((size,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.dim, ctx.group), None, None


def gather_shard(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole leaf from its ``dim``-parts over ``group``; the gradient of
    the whole is reduce-scattered back onto the part."""
    return _GatherShard.apply(shard, dim, group)


# the model axis's process group while a tensor-parallel forward runs. A
# module variable, not a thread-local: on the card autograd runs the
# backward, and with it a rematerialized layer's forward, on its own threads
_MODEL_GROUP = None


@contextlib.contextmanager
def model_parallel(group):
    """Run the model's forward and backward tensor-parallel over ``group``
    (None: one rank, nothing to do)."""
    global _MODEL_GROUP
    prev, _MODEL_GROUP = _MODEL_GROUP, group
    try:
        yield
    finally:
        _MODEL_GROUP = prev


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of column-parallel projections (Megatron's f)."""
    return x if _MODEL_GROUP is None else _CopyToModel.apply(x, _MODEL_GROUP)


def reduce_from_model(y: torch.Tensor) -> torch.Tensor:
    """The partial sums of a row-parallel product, summed (Megatron's g)."""
    return y if _MODEL_GROUP is None else _ReduceFromModel.apply(y, _MODEL_GROUP)


class ProcessGroups(NamedTuple):
    """This rank's place on a mesh: its rank, its data and model indices,
    and the process groups of its data axis and of its model axis (None
    where the axis has one device)."""

    rank: int
    data_index: int
    model_index: int
    data: Optional[object]
    model: Optional[object]


def process_groups(mesh: Mesh) -> ProcessGroups:
    """The data- and model-axis groups of this rank. Every rank makes every
    group (``new_group`` is collective), in the same order."""
    rank = mesh_rank(mesh)
    dp, tp = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    backend = dist.get_backend() if dist.is_initialized() else None
    data = model = None
    if tp > 1:
        for d in range(dp):
            ranks: List[int] = [d * tp + m for m in range(tp)]
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                model = g
    if dp > 1:
        for m in range(tp):
            ranks = [d * tp + m for d in range(dp)]
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                data = g
    d, m = mesh.coords(rank)
    return ProcessGroups(rank, d, m, data, model)
