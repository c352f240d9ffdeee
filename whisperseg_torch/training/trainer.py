"""Training loop (the port of ``whisperseg_tpu/training/trainer.py``).

As in the JAX package: AdamW with biases and LayerNorm gains left out of
weight decay, a linear warmup then linear decay schedule (HF
``get_linear_schedule_with_warmup``), the epoch/iteration reconciliation
with a floor of ``min_num_iterations``, periodic validation with one trial
and greedy decoding, early stop after two validation drops past half the
run, ``checkpoint-{step}`` pruning and ``final_checkpoint`` selection, and
``status.json`` progress. Parameters are float32 leaf tensors on the
training device; compute runs in ``cfg.compute_dtype``.

``torch.optim.AdamW`` with a ``LambdaLR`` equals ``optax.adamw(schedule,
weight_decay, mask)``: the same moments, bias corrections and eps, decay
scaled by the learning rate and applied to the weights before the step, and
the first update taken at ``schedule(0)``. ``optimizer="adafactor"`` is
:class:`Adafactor`, the JAX package's optax chain written out. Dropout and
SpecAugment draw from a ``torch.Generator`` seeded from ``args.seed``; the
data pipeline draws from the global ``np.random`` stream in the JAX
package's order.

The other options of the JAX package: ``qat_bits`` (straight-through fake
quantization of the projection weights inside the loss,
ops/quant.py), ``gqa_kv_heads`` (mean-pool the K/V heads, models/gqa.py,
then train), ``synth_augment`` (splice-synthesized files, augment.py),
``device_pool`` (epoch blocks of crops held on the device, trained by
pretrain.build_scan_train_step) and ``profile_dir`` (a ``torch.profiler``
trace of steps 10-14). An initial model may be a HF checkpoint directory
(models/convert_hf.py). ``use_wandb`` raises ``NotImplementedError`` (the
package is absent).

Several devices (``n_device``, ``tp``, ``fsdp``): one process a device.
The data width is the largest divisor of ``batch_size`` that fits
``n_device // tp``. Without a process group ``run_training`` starts its
ranks itself (``torch.multiprocessing``, rank r on ``cuda:r``, or on the
CPU under ``device="cpu"``; the ranks are spawned, so a script that
calls it needs an ``if __name__ == "__main__":`` guard); under one
(``parallel.multihost.initialize``, e.g. in a script run by ``torchrun``)
it trains over that group. Each rank takes its rows of the
global batch; the token loss and the frame loss divide by the global
batch's totals, so the ranks' gradients sum to the global batch's.
Parameters are laid out by ``parallel.param_pspecs``: tensor-parallel
leaves are cut over the model axis (parallel/mesh.py runs the Megatron
split's collectives), fsdp leaves over the data axis, all-gathered before
use, their gradients reduce-scattered; every other gradient is summed over
the data axis. The optimizers run on the parts; Adafactor's factored
moments and its update clipping reduce across them, and QAT puts each
weight on the grid of the whole leaf. Only rank 0 writes
checkpoints, ``metrics.jsonl`` and status, and runs validation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import (finalize_best_checkpoint, load_checkpoint,
                          save_training_checkpoint)
from ..data import (FRAME_KEYS, DataLoader, VocalSegDataset,
                    get_audio_and_label_paths, get_cluster_codebook, load_data,
                    resolve_default_config, slice_audios_and_labels,
                    train_val_split)
from ..evaluate import evaluate
from ..models.config import WhisperConfig, make_config
from ..models.convert_hf import import_hf_checkpoint
from ..models.gqa import convert_to_gqa
from ..models.whisper import (cross_entropy_loss, decoder_forward_train,
                              encoder_forward, ensure_frame_head,
                              frame_head_forward, frame_head_loss, init_params,
                              sinusoid_position_table)
from ..ops.quant import (QUANT_LEAF_NAMES, fake_grid, fake_quantize_params,
                         ste_to)
from ..parallel import mesh as pmesh
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, batch_sharding, make_mesh,
                             param_pspecs)
from ..parallel.multihost import free_port
from ..profiling import StepTimer, span, trace
from ..runtime import resolve_device
from ..segmenter import Segmenter
from ..tokenizer import NUM_TIMESTAMPS, VOCAB_SIZE


@dataclass
class TrainArgs:
    """The JAX package's training options, plus ``device``."""

    initial_model_path: str = "base"
    model_folder: str = "model"
    train_dataset_folder: str = ""
    n_device: Optional[int] = None
    print_every: int = 100
    validate_every: Optional[int] = None
    validate_per_epoch: bool = False
    save_every: Optional[int] = None
    save_per_epoch: bool = False
    max_num_epochs: int = 3
    max_num_iterations: Optional[int] = None
    min_num_iterations: int = 500
    val_ratio: float = 0.0
    max_length: int = 100
    total_spec_columns: int = 1000
    batch_size: int = 4
    learning_rate: float = 3e-6
    lr_schedule: str = "linear"
    max_to_keep: int = -1
    seed: int = 66100
    weight_decay: float = 0.01
    warmup_steps: int = 100
    freeze_encoder: bool = False
    optimizer: str = "adamw"
    qat_bits: int = 0
    timestamp_loss_weight: float = 1.0  # >1 weighs timestamp targets up
    timestamp_label_sigma: float = 0.0  # >0: Gaussian-soft timestamp targets
    frame_head: bool = False  # train the encoder's frame head jointly
    frame_head_weight: float = 1.0
    frame_boundary_weight: float = 1.0
    frame_label_sigma: float = 1.0
    spec_augment: bool = False
    synth_augment: int = 0
    dropout: float = 0.0
    num_workers: int = 4  # item-loading threads of the DataLoader
    clear_cluster_codebook: bool = True
    ignore_cluster: bool = False
    tp: int = 1
    fsdp: bool = False
    remat: bool = False
    device_pool: bool = False
    gqa_kv_heads: int = 0
    project: str = "whisperseg-tpu"
    run_name: Optional[str] = None
    use_wandb: bool = False
    profile_dir: Optional[str] = None
    device: Optional[str] = None  # the card unless "cpu" is asked for


def _check_supported(args: TrainArgs) -> None:
    if args.use_wandb:
        raise NotImplementedError(
            "use_wandb is not ported: the wandb package is absent (ROADMAP.md "
            "Queue A item 11, not queued)")


def data_width(args: TrainArgs, available: int) -> int:
    """The data axis's width: the largest divisor of ``batch_size`` that
    fits ``available // tp`` devices."""
    if args.tp < 1 or available % args.tp:
        raise ValueError(f"{available} devices not divisible by tp={args.tp}")
    dp_max = max(available // args.tp, 1)
    dp = next(d for d in range(min(dp_max, args.batch_size), 0, -1)
              if args.batch_size % d == 0)
    if dp * args.tp < available:
        print(f"Note: using {dp * args.tp}/{available} devices "
              f"(dp={dp} divides batch_size={args.batch_size}, tp={args.tp})")
    return dp


def _available_devices(args: TrainArgs, device: torch.device) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if args.n_device is not None:
        return args.n_device
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _rank_main(rank: int, args: TrainArgs, world: int, port: int,
               backend: str) -> None:
    """One rank of :func:`_spawn_ranks`."""
    on_cpu = backend == "gloo"
    if on_cpu:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        run_training(dataclasses.replace(
            args, device="cpu" if on_cpu else f"cuda:{rank}"))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(args: TrainArgs, device: torch.device,
                 world: int) -> Optional[str]:
    """Train on ``world`` local ranks (``cuda:r``, or the CPU), one process
    each over a new process group (NCCL, gloo on the CPU); a rank that fails
    stops the others and raises here."""
    import torch.multiprocessing as mp

    if device.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"{world} CUDA ranks asked for, but this machine has "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    backend = "nccl" if device.type == "cuda" else "gloo"
    ctx = mp.start_processes(_rank_main, args=(args, world, free_port(),
                                               backend),
                             nprocs=world, join=False, start_method="spawn")
    while not ctx.join():
        pass
    final = os.path.join(args.model_folder, "final_checkpoint")
    return final if os.path.isdir(final) else None


class _Parallel:
    """One rank's share of a multi-device run: its place on the mesh
    (``parallel.mesh.ProcessGroups``), each leaf's spec, and the collectives
    of a step."""

    def __init__(self, mesh, groups, specs, tp: int):
        self.mesh, self.groups, self.specs, self.tp = mesh, groups, specs, tp
        self.main = groups.rank == 0

    def _group(self, axis):
        return self.groups.data if axis == DATA_AXIS else self.groups.model

    def local_cfg(self, cfg: WhisperConfig) -> WhisperConfig:
        """The forward's config on this rank: ``num_heads / tp`` and
        ``kv_heads / tp`` heads of the same width."""
        if self.tp == 1:
            return cfg
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // self.tp,
                                   num_kv_heads=cfg.kv_heads // self.tp)

    def shards(self, params) -> Dict[torch.Tensor, tuple]:
        """leaf -> (dim, group, parts) for each leaf cut over an axis of
        more than one device."""
        out = {}
        for (_, leaf), (_, spec) in zip(_leaves(params), _leaves(self.specs)):
            for dim, axis in enumerate(spec):
                if axis is not None and self._group(axis) is not None:
                    out[leaf] = (dim, self._group(axis),
                                 self.mesh.shape[axis])
        return out

    def gather(self, params):
        """The tree the forward uses: fsdp leaves all-gathered (their
        gradients reduce-scattered back)."""
        def one(leaf, spec):
            if DATA_AXIS in spec and self.groups.data is not None:
                return pmesh.gather_shard(leaf, spec.index(DATA_AXIS),
                                          self.groups.data)
            return leaf
        return pmesh.tree_map(params, one, self.specs)

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        return pmesh.all_reduce(t, self.groups.data)

    def reduce_grads(self, params) -> None:
        """Sum the gradients of the leaves not cut over the data axis over
        it (one collective for all)."""
        if self.groups.data is None:
            return
        grads = [leaf.grad for (_, leaf), (_, spec)
                 in zip(_leaves(params), _leaves(self.specs))
                 if leaf.grad is not None and DATA_AXIS not in spec]
        if not grads:
            return
        flat = self.sum_data(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    @torch.no_grad()
    def full(self, params):
        """Every leaf whole (a collective: every rank calls it)."""
        def one(leaf, spec):
            for dim, axis in enumerate(spec):
                if axis is not None and self._group(axis) is not None:
                    leaf = pmesh.all_gather(leaf, dim, self._group(axis))
            return leaf.detach()
        return pmesh.tree_map(params, one, self.specs)

    def broadcast(self, value):
        """Rank 0's ``value`` (a picklable object) on every rank."""
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def fake_quantize(self, params, bits: int):
        """``fake_quantize_params`` with each grid taken over the whole
        leaf, as on one device: a projection weight cut over the model axis
        on its contraction dim (o/fc2/xo under tp) has per-channel scales,
        and int4 groups, that span the ranks, so it is gathered, put on its
        grid and cut again; its gradient passes straight through to the
        part. Column-parallel weights hold whole channels and groups."""
        def walk(tree, specs):
            out = {}
            for k, v in tree.items():
                spec = specs[k]
                if isinstance(v, dict):
                    out[k] = walk(v, spec)
                elif (k in QUANT_LEAF_NAMES and len(spec) >= 2
                      and spec[-2] == MODEL_AXIS):
                    whole = pmesh.all_gather(v, v.dim() - 2, self.groups.model)
                    out[k] = ste_to(v, pmesh.local_part(
                        fake_grid(whole, bits), spec, self.mesh,
                        self.groups.rank))
                else:
                    out[k] = fake_quantize_params({k: v}, bits)[k]
            return out
        return walk(params, self.specs)

    def rows(self, batch: Dict) -> Dict:
        """This rank's rows of a global batch of tensors (``batch_sharding``'s
        split over the data axis), wrapped around to a multiple of the data
        width first (the short tail batch of a small dataset)."""
        dp, spec = self.mesh.shape[DATA_AXIS], batch_sharding(self.mesh).spec

        def cut(v):
            if isinstance(v, dict):
                return {k: cut(x) for k, x in v.items()}
            if v.shape[0] % dp:
                v = torch.cat([v, v[:dp - v.shape[0] % dp]])
            return pmesh.local_part(v, spec, self.mesh, self.groups.rank)
        return {k: cut(v) for k, v in batch.items()}


def _parallel_layout(args: TrainArgs, device: torch.device, params,
                     cfg: WhisperConfig, dp: int) -> _Parallel:
    """The mesh of the process group (each rank's own device at its place)
    and this rank's groups and leaf specs."""
    world = dist.get_world_size()
    if world != dp * args.tp:
        raise ValueError(f"a process group of {world} ranks cannot run dp={dp} "
                         f"x tp={args.tp}")
    names = [None] * world
    dist.all_gather_object(names, str(device))
    mesh = make_mesh(tp=args.tp, devices=names)
    specs = param_pspecs(params, cfg, tp=args.tp > 1, fsdp=args.fsdp,
                         data_size=dp)
    return _Parallel(mesh, pmesh.process_groups(mesh), specs, args.tp)


def load_model_any(path_or_name: str, total_spec_columns: int, dropout: float):
    """An initial model: a checkpoint directory (``params.npz``), whose
    encoder position table is cut or sinusoid-extended to
    ``total_spec_columns // 2`` rows, a HuggingFace checkpoint directory
    (models/convert_hf.py), or a family size name ('tiny' .. 'large') for
    fresh weights. Returns float32 CPU tensors and the config."""
    if os.path.isdir(path_or_name):
        if not os.path.exists(os.path.join(path_or_name, "params.npz")):
            params, cfg = import_hf_checkpoint(path_or_name, total_spec_columns)
            cfg.dropout = dropout
            return params, cfg
        params, cfg = load_checkpoint(path_or_name)
        cfg.dropout = dropout
        cfg.total_spec_columns = total_spec_columns
        new_positions = total_spec_columns // 2
        pos = params["encoder"]["pos_emb"]
        if pos.shape[0] > new_positions:
            pos = pos[:new_positions]
        elif pos.shape[0] < new_positions:
            ext = torch.from_numpy(sinusoid_position_table(new_positions,
                                                           pos.shape[1]))
            ext[: pos.shape[0]] = pos
            pos = ext
        params["encoder"]["pos_emb"] = pos.contiguous()
        cfg.max_source_positions = new_positions
        return params, cfg
    cfg = make_config(path_or_name, total_spec_columns=total_spec_columns,
                      dropout=dropout)
    return init_params(torch.Generator().manual_seed(0), cfg), cfg


def _decay_mask(params) -> dict:
    """True where weight decay applies: every leaf but biases (``_b``) and
    norm gains (``_g``)."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return not (name.endswith("_b") or name.endswith("_g"))

    return walk(params)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, name)
        else:
            yield name, v


class Adafactor(torch.optim.Optimizer):
    """The JAX package's adafactor, optax's chain written out, in its order:

      1. ``scale_by_factored_rms(min_dim_size_to_factor=32)``: decay rate
         ``1 - (t + 1) ** -0.8`` at update count t, epsilon 1e-30 added to
         the squared gradient; a leaf whose second-largest dim is at least
         32 keeps factored row and column statistics over its two largest
         dims (``numpy.argsort`` of the shape picks them), the others a full
         one; no first moment;
      2. ``clip_by_block_rms(1.0)``: each leaf's update divided by
         ``max(1, rms(update))``;
      3. ``add_decayed_weights`` with the group's ``weight_decay``, before
         the learning rate, so the decay is ``lr * weight_decay``;
      4. the learning rate (the group's ``lr``, set by a ``LambdaLR``).

    ``torch.optim.Adafactor`` differs in its decay schedule, clipping and
    order of decay, so it is not used."""

    DECAY_EXPONENT = 0.8
    EPSILON = 1e-30
    CLIP_RMS = 1.0
    MIN_DIM_SIZE_TO_FACTOR = 32

    def __init__(self, params, lr: float = 1.0, weight_decay: float = 0.0,
                 shards: Optional[Dict[torch.Tensor, tuple]] = None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        # leaf -> (dim, group, parts) of leaves cut across ranks: their
        # statistics reduce over the whole leaf, as on one device
        self.shards = shards or {}

    @classmethod
    def factored_dims(cls, shape):
        """(row dim, column dim) of a factored leaf, or None (optax's
        ``_factored_dims``): the reduced dims are the two largest."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < cls.MIN_DIM_SIZE_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                cut, across, parts = self.shards.get(p, (None, None, 1))
                full_shape = tuple(n * parts if i == cut else n
                                   for i, n in enumerate(p.shape))

                def mean(x, dim, kept_dim=None):
                    """Mean over ``dim``, across ranks where ``dim`` (at
                    ``kept_dim`` of the leaf) is the cut one."""
                    m = x.mean(dim=dim, keepdim=kept_dim is not None)
                    if cut is not None and (kept_dim if kept_dim is not None
                                            else dim) == cut:
                        m = pmesh.all_reduce(m, across) / parts
                    return m

                dims = self.factored_dims(full_shape)
                if not state:
                    state["step"] = 0
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        state["v_row"] = p.new_zeros(
                            [n for i, n in enumerate(p.shape) if i != d0])
                        state["v_col"] = p.new_zeros(
                            [n for i, n in enumerate(p.shape) if i != d1])
                t = torch.tensor(state["step"] + 1, dtype=torch.float32)
                beta = float(1.0 - t ** -self.DECAY_EXPONENT)
                g2 = g * g + self.EPSILON
                if dims is None:
                    v = state["v"].mul_(beta).add_((1.0 - beta) * g2)
                    u = g * v.rsqrt()
                else:
                    d1, d0 = dims
                    v_row = state["v_row"].mul_(beta).add_(
                        (1.0 - beta) * mean(g2, d0))
                    v_col = state["v_col"].mul_(beta).add_(
                        (1.0 - beta) * mean(g2, d1))
                    r = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / mean(v_row, r, kept_dim=d1)).rsqrt()
                    u = (g * row_factor.unsqueeze(d0)
                         * v_col.rsqrt().unsqueeze(d1))
                if cut is None:
                    rms = torch.sqrt(torch.mean(u * u))
                else:
                    rms = torch.sqrt(pmesh.all_reduce((u * u).sum(), across)
                                     / float(np.prod(full_shape)))
                u = u / torch.clamp(rms / self.CLIP_RMS, min=1.0)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.add_(u, alpha=-group["lr"])
                state["step"] += 1
        return None


def make_optimizer(params, learning_rate: float, weight_decay: float,
                   warmup_steps: int, total_steps: int, lr_schedule: str,
                   freeze_encoder: bool, optimizer: str = "adamw",
                   shards: Optional[Dict[torch.Tensor, tuple]] = None):
    """(optimizer, its LambdaLR, schedule): AdamW or :class:`Adafactor`.
    Two parameter groups, with and without weight decay; under
    ``freeze_encoder`` the encoder's leaves are left out (the JAX package
    zeroes their updates), so they never change. The group learning rate is
    ``schedule(step)`` itself. ``shards`` (``_Parallel.shards``) names the
    leaves cut across ranks, whose Adafactor statistics span the ranks."""
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if lr_schedule == "linear":
        # HF get_linear_schedule_with_warmup
        def schedule(step: int) -> float:
            if step < warmup_steps:
                return learning_rate * step / max(warmup_steps, 1)
            return learning_rate * max(
                0.0, (total_steps - step) / max(total_steps - warmup_steps, 1))
    else:
        def schedule(step: int) -> float:
            return learning_rate
    mask = dict(_leaves(_decay_mask(params)))
    decay, no_decay = [], []
    for name, leaf in _leaves(params):
        if freeze_encoder and name.split(".")[0] == "encoder":
            continue
        (decay if mask[name] else no_decay).append(leaf)
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    if optimizer == "adafactor":
        opt = Adafactor(groups, lr=1.0, shards=shards)
    else:
        opt = torch.optim.AdamW(groups, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, schedule)
    return opt, scheduler, schedule


def spec_augment(features: torch.Tensor, gen: torch.Generator,
                 n_freq_masks: int = 2, freq_width: int = 10,
                 n_time_masks: int = 2, time_width: int = 30) -> torch.Tensor:
    """SpecAugment-style frequency and time stripes per example, filled with
    the example's feature minimum (the frontend's padding value, so a mask
    looks like silence). Stripe starts are drawn from ``gen``."""
    b, m, t = features.shape
    dev = features.device
    fill = features.amin(dim=(1, 2), keepdim=True)
    masked = features
    for idx, n_masks, width, size in (
            (torch.arange(m, device=dev)[None, :, None], n_freq_masks, freq_width, m),
            (torch.arange(t, device=dev)[None, None, :], n_time_masks, time_width, t)):
        for _ in range(n_masks):
            start = torch.randint(0, max(size - width, 1), (b, 1, 1),
                                  generator=gen).to(dev)
            masked = torch.where((idx >= start) & (idx < start + width), fill,
                                 masked)
    return masked


def batch_to_device(batch: Dict, device) -> Dict:
    """Collated numpy arrays -> tensors on ``device`` (ids and labels as
    int64, frame targets as float32 and int64 clusters)."""
    with span("train.to_device"):
        out = {"input_features": batch["input_features"].to(device),
               "decoder_input_ids": torch.from_numpy(
                   batch["decoder_input_ids"]).to(device, torch.long),
               "labels": torch.from_numpy(batch["labels"]).to(device,
                                                               torch.long)}
        if "frame_targets" in batch:
            ft = batch["frame_targets"]
            out["frame_targets"] = {
                k: torch.from_numpy(ft[k]).to(
                    device, torch.long if k == "cluster" else torch.float32)
                for k in FRAME_KEYS}
        return out


def build_train_step(cfg: WhisperConfig, optimizer, scheduler, qat_bits: int = 0,
                     timestamp_loss_weight: float = 1.0,
                     timestamp_label_sigma: float = 0.0,
                     use_spec_augment: bool = False,
                     frame_head_weight: float = 0.0,
                     frame_boundary_weight: float = 1.0,
                     parallel: Optional[_Parallel] = None):
    """``step(params, batch, gen) -> loss``: forward, backward, one update
    of ``optimizer`` and one schedule step. Under ``parallel`` ``params``
    are this rank's parts and ``batch`` its rows; the loss returned is this
    rank's share of the global batch's (the shares summed over the data
    axis are the loss). ``batch`` holds tensors on the
    params' device (``batch_to_device``); ``gen`` (a CPU
    ``torch.Generator``) feeds dropout and SpecAugment. ``qat_bits`` (8 or
    4) puts the projection weights on their quantization grid inside the
    loss (``fake_quantize_params``); the float32 master weights take the
    straight-through gradient. The loss comes back as a device scalar, so
    the host does not wait for the step; this step's gradients stay in each
    leaf's ``.grad``. The step is the span ``train.step``, its phases
    ``train.forward``, ``train.backward`` and ``train.optimizer``."""
    if qat_bits not in (0, 4, 8):
        raise ValueError(f"qat_bits must be 0, 4 or 8, got {qat_bits}")
    train = cfg.dropout > 0
    fcfg = cfg if parallel is None else parallel.local_cfg(cfg)
    allreduce = None if parallel is None else parallel.sum_data
    model_group = None if parallel is None else parallel.groups.model

    def forward(params, batch, gen):
        optimizer.zero_grad(set_to_none=True)
        features = batch["input_features"]
        if use_spec_augment:
            features = spec_augment(features, gen)
        p = params if parallel is None else parallel.gather(params)
        if qat_bits:
            p = (fake_quantize_params(p, qat_bits) if model_group is None
                 else parallel.fake_quantize(p, qat_bits))
        enc = encoder_forward(p, fcfg, features, train=train, generator=gen)
        logits = decoder_forward_train(p, fcfg, enc,
                                       batch["decoder_input_ids"],
                                       train=train, generator=gen)
        loss = cross_entropy_loss(logits, batch["labels"],
                                  timestamp_weight=timestamp_loss_weight,
                                  timestamp_sigma=timestamp_label_sigma,
                                  allreduce=allreduce)
        if frame_head_weight > 0 and "frame_targets" in batch:
            floss = frame_head_loss(frame_head_forward(p, fcfg, enc),
                                    batch["frame_targets"],
                                    boundary_weight=frame_boundary_weight,
                                    allreduce=allreduce)
            loss = loss + frame_head_weight * floss
        return loss

    def step(params, batch, gen: torch.Generator) -> torch.Tensor:
        with span("train.step"):
            with span("train.forward"), pmesh.model_parallel(model_group):
                loss = forward(params, batch, gen)
            with span("train.backward"):
                with pmesh.model_parallel(model_group):
                    loss.backward()
                if parallel is not None:
                    parallel.reduce_grads(params)
            with span("train.optimizer"):
                optimizer.step()
                scheduler.step()
            return loss.detach()

    return step


def training_params(params, device, freeze_encoder: bool = False) -> dict:
    """float32 leaves on ``device`` that take gradients (the encoder's not,
    under ``freeze_encoder``)."""
    def walk(tree, frozen):
        return {k: walk(v, frozen or (freeze_encoder and k == "encoder"))
                if isinstance(v, dict) else
                v.detach().to(device=device, dtype=torch.float32)
                .contiguous().requires_grad_(not frozen)
                for k, v in tree.items()}

    return walk(params, False)


def _run_device_pool_loop(args: TrainArgs, cfg, optimizer, scheduler,
                          schedule, params, dataset, segmenter, audio_list_val,
                          label_list_val, log_metrics) -> Optional[str]:
    """Epoch-block training over a pool held on the device (``device_pool``).

    Each block takes one fresh random crop of every dataset item (the
    augmentation of the per-step loader), collates the crops on the device
    grouped by frontend configuration (one mel-kernel launch a group), and
    runs ``len(dataset) // batch_size`` optimizer steps over a shuffled
    pass of the pool through ``pretrain.build_scan_train_step``: batches are
    gathered on the device and the losses read once a block. The next
    block's crops are made on a worker thread meanwhile; their generators
    are drawn on this thread first, so a seed gives the same crops. The
    last block stops at ``max_num_iterations``; validation and saving
    happen at the first block boundary past each multiple of
    ``validate_every`` / ``save_every``. The pool holds about N * 80 *
    total_spec_columns * 4 bytes of features."""
    from ..pretrain import build_scan_train_step, stack_batches

    device = dataset.device
    n, b = len(dataset), args.batch_size
    steps_per_block = max(n // b, 1)
    by_key: Dict = {}
    for i, label in enumerate(dataset.label_list):
        key = (label["sr"], label["spec_time_step"],
               label.get("min_frequency", 0))
        by_key.setdefault(key, []).append(i)
    groups_idx = list(by_key.values())

    def draw_rngs():
        return [np.random.RandomState(np.random.randint(2 ** 31))
                for _ in range(n)]

    def make_items(rngs):
        return [[dataset.__getitem__(i, rng=rngs[i]) for i in idxs]
                for idxs in groups_idx]

    train_k = build_scan_train_step(
        cfg, optimizer, scheduler, steps_per_block, b, qat_bits=args.qat_bits,
        timestamp_loss_weight=args.timestamp_loss_weight,
        timestamp_label_sigma=args.timestamp_label_sigma,
        use_spec_augment=args.spec_augment,
        frame_head_weight=args.frame_head_weight if args.frame_head else 0.0,
        frame_boundary_weight=args.frame_boundary_weight)

    pending: dict = {}

    def gen_worker(rngs):
        pending["items"] = make_items(rngs)

    groups = make_items(draw_rngs())
    gen = torch.Generator().manual_seed(args.seed)
    step = epoch = 0
    val_score_history: List = []
    best_step: Optional[int] = None
    early_stop = False
    start_time = timer_t0 = time.time()
    segmenter.params = params

    while step < args.max_num_iterations and not early_stop:
        pool = stack_batches([dataset.collate(items) for items in groups])
        t_gen = threading.Thread(target=gen_worker, args=(draw_rngs(),))
        t_gen.start()
        try:
            # pool rows are in group order; a shuffled full pass over it
            perm = np.random.permutation(max(n, steps_per_block * b))[
                : steps_per_block * b] % n
            k = min(steps_per_block, args.max_num_iterations - step)
            idx = torch.from_numpy(perm.reshape(steps_per_block, b)[:k]).to(
                device)
            losses = train_k(params, pool, idx, gen)
            prev = step
            step += k
            epoch += 1
            mean_loss = float(losses.mean())  # the block's one host sync
            lr_now = float(schedule(step))
            rate = step / max(time.time() - timer_t0, 1e-9)
            print(f"Epoch: {epoch}, current_step: {step}, "
                  f"learning rate: {lr_now:.8f}, Loss: {mean_loss:.4f}")
            log_metrics({"current_step": step, "epoch": epoch,
                         "train/loss": mean_loss, "train/learning_rate": lr_now,
                         "perf/steps_per_s": round(rate, 2)})
            frac = step / args.max_num_iterations
            _write_status(args.model_folder, int(np.round(frac * 100)),
                          int((time.time() - start_time) / frac * (1 - frac)))

            def crossed(every):
                return every is not None and step // every > prev // every

            if ((crossed(args.validate_every) or args.validate_per_epoch)
                    and len(audio_list_val) > 0):
                eval_res = evaluate(audio_list_val, label_list_val, segmenter,
                                    args.batch_size, args.max_length,
                                    num_trials=1, num_beams=1, verbose=False)
                seg_f1 = eval_res["segment_wise"][-1]
                frame_f1 = eval_res["frame_wise"][-1]
                score = (seg_f1 + frame_f1) * 0.5
                print(f"Epoch: {epoch}, current_step: {step}, "
                      f"validation segment F1: {seg_f1:.4f}, "
                      f"frame F1: {frame_f1:.4f}")
                log_metrics({"current_step": step, "validate/score": score,
                             "validate/segment_score": seg_f1,
                             "validate/frame_score": frame_f1})
                is_new_best = (not val_score_history
                               or score > max(x for _, x in val_score_history))
                val_score_history.append((step, score))
                if is_new_best:
                    best_step = step
                    save_training_checkpoint(args.model_folder, params, cfg,
                                             step, args.max_to_keep,
                                             keep_step=best_step)
            if crossed(args.save_every) or args.save_per_epoch:
                save_training_checkpoint(args.model_folder, params, cfg, step,
                                         args.max_to_keep, keep_step=best_step)
            if (step >= 0.5 * args.max_num_iterations
                    and len(val_score_history) >= 3
                    and val_score_history[-1][1] < val_score_history[-2][1]
                    < val_score_history[-3][1]):
                early_stop = True
        finally:
            t_gen.join()
        groups = pending["items"]

    if not os.path.exists(os.path.join(args.model_folder,
                                       f"checkpoint-{step}")):
        save_training_checkpoint(args.model_folder, params, cfg, step,
                                 args.max_to_keep, keep_step=best_step)
    return _finish(args.model_folder, val_score_history, best_step)


def _write_status(model_folder: str, progress: int, eta_s: int) -> None:
    with open(os.path.join(model_folder, "status.json"), "w") as f:
        json.dump({"progress": progress,
                   "eta": "%02d:%02d:%02d" % (eta_s // 3600, (eta_s % 3600) // 60,
                                              eta_s % 60)}, f)


def run_training(args: TrainArgs) -> Optional[str]:
    """A full training run on ``args.device`` (the card unless "cpu"), or
    over several devices (module docstring); returns the
    ``final_checkpoint`` path, or None (on ranks other than 0 too)."""
    device = resolve_device(args.device)
    _check_supported(args)
    in_group = dist.is_available() and dist.is_initialized()
    if in_group and device.type == "cuda":
        if args.device is None:  # a rank of torchrun or multihost: its card
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
        if device.index is not None:
            torch.cuda.set_device(device)
    dp = data_width(args, _available_devices(args, device))
    if args.device_pool and dp * args.tp > 1:
        raise ValueError("--device_pool supports single-device training "
                         "only (pass --n_device 1, and drop --tp/--fsdp)")
    if dp * args.tp > 1 and not in_group:
        return _spawn_ranks(args, device, dp * args.tp)
    np.random.seed(args.seed)
    if args.total_spec_columns > NUM_TIMESTAMPS - 1:
        raise ValueError(
            f"--total_spec_columns {args.total_spec_columns} exceeds the "
            f"timestamp vocabulary ({NUM_TIMESTAMPS - 1} columns max); the "
            f"model input geometry is fixed at <= 1000 spectrogram columns")
    if args.val_ratio == 0.0:
        args.validate_every = None
        args.validate_per_epoch = False
    os.makedirs(args.model_folder, exist_ok=True)

    params, cfg = load_model_any(args.initial_model_path,
                                 args.total_spec_columns, args.dropout)
    cfg.remat = args.remat
    if args.gqa_kv_heads and cfg.kv_heads != args.gqa_kv_heads:
        # GQA uptraining: mean-pool the K/V heads of each group, then train
        params, cfg = convert_to_gqa(params, cfg, args.gqa_kv_heads)
        cfg.remat = args.remat
        print(f"Converted initial model to GQA (kv_heads={args.gqa_kv_heads}).")
    if args.max_length > cfg.max_target_positions:
        print(f"Warning: max_length {args.max_length} exceeds the model's "
              f"max_target_positions {cfg.max_target_positions}; clamping.")
        args.max_length = cfg.max_target_positions

    # validation runs on the live float32 training weights (set below)
    segmenter = Segmenter(params, cfg, inference_dtype=None, device=device)
    if args.clear_cluster_codebook:
        segmenter.update_cluster_codebook({})

    # ----------------------------------------------------------------- data
    audio_paths, label_paths = get_audio_and_label_paths(args.train_dataset_folder)
    default_config = resolve_default_config(
        audio_paths, label_paths, args.total_spec_columns,
        ignore_cluster=args.ignore_cluster)
    # the stored defaults also record the decode budget the model trains at
    stored_config = dict(default_config)
    stored_config["max_length"] = int(args.max_length)
    cfg.default_segmentation_config = stored_config
    segmenter.default_segmentation_config = dict(stored_config)

    cluster_codebook = get_cluster_codebook(
        label_paths, segmenter.cluster_codebook, ignore_cluster=args.ignore_cluster)
    segmenter.update_cluster_codebook(cluster_codebook)

    if args.frame_head:
        cfg.frame_head = True
        cfg.frame_head_clusters = (max(cluster_codebook.values()) + 1
                                   if cluster_codebook else 0)
        params = ensure_frame_head(
            params, cfg, torch.Generator().manual_seed(args.seed ^ 0x5E6))
        print(f"Frame head enabled ({cfg.frame_head_clusters} cluster "
              f"channel(s)).")
    parallel = None
    if dp * args.tp > 1:
        parallel = _parallel_layout(args, device, params, cfg, dp)
        params = training_params(
            pmesh.shard_params(parallel.mesh, params, cfg, tp=args.tp > 1,
                               fsdp=args.fsdp), device, args.freeze_encoder)
        print(f"Rank {parallel.groups.rank}/{parallel.mesh.size}: dp={dp}, "
              f"tp={args.tp}, fsdp={bool(args.fsdp)}, "
              f"backend={dist.get_backend()}, device={device}")
    else:
        params = training_params(params, device, args.freeze_encoder)

    audio_list, label_list = load_data(
        audio_paths, label_paths, cluster_codebook=cluster_codebook, n_threads=20,
        default_config=default_config, ignore_cluster=args.ignore_cluster)
    audio_list_val, label_list_val = [], []
    if args.val_ratio > 0:
        (audio_list, label_list), (audio_list_val, label_list_val) = \
            train_val_split(audio_list, label_list, args.val_ratio)
        n_val_segments = int(sum(len(l.get("onset", [])) for l in label_list_val))
        if len(audio_list_val) < 3 or n_val_segments < 50:
            print(f"Warning: validation split is tiny ({len(audio_list_val)} "
                  f"file(s), {n_val_segments} segment(s)). Validation F1 will "
                  f"be noisy; early stopping and best-checkpoint selection may "
                  f"pick a worse model than the last step. Consider a larger "
                  f"--val_ratio, more data, or val_ratio=0 with a fixed "
                  f"iteration budget.")
    if args.synth_augment > 0:
        # splice-synthesized files from the training split's own syllables
        # and noise, after the validation split so validation stays real
        from ..augment import synthesize_training_files

        synth_audio, synth_label = synthesize_training_files(
            audio_list, label_list, args.synth_augment,
            total_spec_columns=args.total_spec_columns)
        n_synth_segments = int(sum(len(l["onset"]) for l in synth_label))
        print(f"Synth augmentation: +{len(synth_audio)} file(s), "
              f"{n_synth_segments} spliced segment(s).")
        audio_list = list(audio_list) + synth_audio
        label_list = list(label_list) + synth_label
    audio_list, label_list = slice_audios_and_labels(audio_list, label_list,
                                                     args.total_spec_columns)

    extra_token_ids = {p: VOCAB_SIZE + i
                       for i, p in enumerate(cfg.extra_tokens)} or None
    dataset = VocalSegDataset(audio_list, label_list, args.max_length,
                              args.total_spec_columns,
                              extra_token_ids=extra_token_ids,
                              cluster_encodings=cfg.cluster_encodings or None,
                              frame_targets=args.frame_head,
                              frame_sigma=args.frame_label_sigma, device=device)
    loader = DataLoader(dataset, args.batch_size, shuffle=True, drop_last=True,
                        num_workers=args.num_workers)
    if len(loader) == 0:
        loader = DataLoader(dataset, args.batch_size, shuffle=True,
                            drop_last=False, num_workers=args.num_workers)
    if len(loader) == 0:
        raise RuntimeError("Too few examples (less than a batch) for training!")

    # ------------------------------------------------- schedule reconciliation
    if args.max_num_iterations is not None and args.max_num_iterations > 0:
        args.max_num_epochs = int(np.ceil(args.max_num_iterations / len(loader)))
    else:
        assert args.max_num_epochs and args.max_num_epochs > 0
        args.max_num_iterations = len(loader) * args.max_num_epochs
        if args.min_num_iterations is not None:
            args.max_num_iterations = max(args.max_num_iterations,
                                          args.min_num_iterations)
            args.max_num_epochs = int(np.ceil(args.max_num_iterations / len(loader)))

    optimizer, scheduler, schedule = make_optimizer(
        params, args.learning_rate, args.weight_decay, args.warmup_steps,
        args.max_num_iterations, args.lr_schedule, args.freeze_encoder,
        optimizer=args.optimizer,
        shards=None if parallel is None else parallel.shards(params))
    train_step = build_train_step(
        cfg, optimizer, scheduler, qat_bits=args.qat_bits,
        timestamp_loss_weight=args.timestamp_loss_weight,
        timestamp_label_sigma=args.timestamp_label_sigma,
        use_spec_augment=args.spec_augment,
        frame_head_weight=args.frame_head_weight if args.frame_head else 0.0,
        frame_boundary_weight=args.frame_boundary_weight,
        parallel=parallel)

    metrics_path = os.path.join(args.model_folder, "metrics.jsonl")

    def log_metrics(d):
        if parallel is not None and not parallel.main:
            return
        with open(metrics_path, "a") as f:
            f.write(json.dumps(d) + "\n")

    if args.device_pool:
        final = _run_device_pool_loop(args, cfg, optimizer, scheduler,
                                      schedule, params, dataset, segmenter,
                                      audio_list_val, label_list_val,
                                      log_metrics)
        if final:
            print(f"Final checkpoint: {final}")
        print("All Done!")
        return final

    # ----------------------------------------------------------------- the loop
    # profile_dir: a torch.profiler trace of steps 10-14, closed at the
    # latest when the loop ends
    profiling = contextlib.ExitStack()
    with profiling:
        final = _train_loop(args, cfg, params, loader, train_step, schedule,
                            segmenter, audio_list_val, label_list_val,
                            log_metrics, device, profiling, parallel)
    if final:
        print(f"Final checkpoint: {final}")
    print("All Done!")
    return final


def _train_loop(args: TrainArgs, cfg, params, loader, train_step, schedule,
                segmenter, audio_list_val, label_list_val, log_metrics, device,
                profiling: contextlib.ExitStack,
                parallel: Optional[_Parallel] = None) -> Optional[str]:
    """The per-step loop of :func:`run_training`; returns the final
    checkpoint's path. Under ``parallel`` every rank takes the same
    decisions (rank 0's validation score is broadcast) and only rank 0
    validates, saves and reports."""
    main = parallel is None or parallel.main
    # dropout and SpecAugment: one stream for each data index
    gen = torch.Generator().manual_seed(
        args.seed + (0 if parallel is None else parallel.groups.data_index))

    def whole():
        return params if parallel is None else parallel.full(params)

    def save(step):
        full = whole()
        if main:
            save_training_checkpoint(args.model_folder, full, cfg, step,
                                     args.max_to_keep, keep_step=best_step)

    current_step = 0
    loss_window: List[torch.Tensor] = []
    val_score_history: List = []
    best_step: Optional[int] = None  # exempt from max_to_keep pruning
    early_stop = False
    progress = 0
    start_time = time.time()
    timer = StepTimer()
    segmenter.params = params  # validation on the live weights

    for epoch in range(args.max_num_epochs + 1):
        for count, batch in enumerate(loader):
            if args.profile_dir and current_step == 10:
                profiling.enter_context(trace(args.profile_dir))
            batch = batch_to_device(batch, device)
            if parallel is not None:
                batch = parallel.rows(batch)
            # the loss stays on the device until print_every: no per-step sync
            loss_window.append(train_step(params, batch, gen))
            if args.profile_dir and current_step == 14:
                profiling.close()
            timer.tick()
            current_step += 1

            frac = current_step / args.max_num_iterations
            current_progress = int(np.round(frac * 100))
            if current_progress > progress and main:
                _write_status(args.model_folder, current_progress,
                              int((time.time() - start_time) / frac * (1 - frac)))
            progress = current_progress

            if current_step % args.print_every == 0:
                # the ranks' shares summed once a window (every rank takes part)
                window = torch.stack(loss_window)
                if parallel is not None:
                    window = parallel.sum_data(window)
                loss_window = []
                if main:
                    lr_now = float(schedule(current_step))
                    mean_loss = float(np.mean(window.cpu().numpy()))
                    print(f"Epoch: {epoch}, current_step: {current_step}, "
                          f"learning rate: {lr_now:.8f}, Loss: {mean_loss:.4f}")
                    log_metrics({"current_step": current_step, "epoch": epoch,
                                 "train/loss": mean_loss,
                                 "train/learning_rate": lr_now,
                                 **{f"perf/{k}": v
                                    for k, v in timer.summary().items()}})

            run_validation = (
                (args.validate_every is not None
                 and current_step % args.validate_every == 0)
                or (args.validate_per_epoch and count == len(loader) - 1))
            if run_validation and len(audio_list_val) > 0:
                full = whole()
                score = None
                if main:
                    segmenter.params = full
                    eval_res = evaluate(audio_list_val, label_list_val,
                                        segmenter, args.batch_size,
                                        args.max_length, num_trials=1,
                                        num_beams=1, verbose=False)
                    seg_f1 = eval_res["segment_wise"][-1]
                    frame_f1 = eval_res["frame_wise"][-1]
                    score = (seg_f1 + frame_f1) * 0.5
                    print(f"Epoch: {epoch}, current_step: {current_step}, "
                          f"validation segment F1: {seg_f1:.4f}, "
                          f"frame F1: {frame_f1:.4f}")
                    log_metrics({"current_step": current_step,
                                 "validate/score": score,
                                 "validate/segment_score": seg_f1,
                                 "validate/frame_score": frame_f1})
                if parallel is not None:
                    score = parallel.broadcast(score)
                is_new_best = (not val_score_history
                               or score > max(s for _, s in val_score_history))
                val_score_history.append((current_step, score))
                if is_new_best:
                    # finalize_best_checkpoint picks among saved checkpoints
                    best_step = current_step
                    save(current_step)

            if ((args.save_every is not None
                 and current_step % args.save_every == 0)
                    or (args.save_per_epoch and count == len(loader) - 1)):
                save(current_step)

            if (current_step >= 0.5 * args.max_num_iterations
                    and len(val_score_history) >= 3
                    and val_score_history[-1][1] < val_score_history[-2][1]
                    < val_score_history[-3][1]):
                early_stop = True

            if current_step >= args.max_num_iterations or early_stop:
                saved = os.path.exists(os.path.join(
                    args.model_folder, f"checkpoint-{current_step}"))
                if parallel is not None:
                    saved = parallel.broadcast(saved)
                if not saved:
                    save(current_step)
                break
        if current_step >= args.max_num_iterations or early_stop:
            break

    if not main:
        return None
    return _finish(args.model_folder, val_score_history, best_step)


def _finish(model_folder: str, val_score_history: List,
            best_step: Optional[int]) -> Optional[str]:
    """Status 100 %, then ``final_checkpoint`` from the best validation
    step (else the last saved one); the status file is removed."""
    _write_status(model_folder, 100, 0)
    if val_score_history:
        best_step = sorted(val_score_history, key=lambda x: -x[1])[0][0]
    final = finalize_best_checkpoint(model_folder, best_step)
    try:
        os.remove(os.path.join(model_folder, "status.json"))
    except OSError:
        pass
    return final
