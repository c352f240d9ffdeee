"""Synthetic task pretraining: a manufactured initialization (the port of
``whisperseg_tpu/pretrain.py``).

Randomized synthetic vocalization corpora (tones, harmonic stacks, chirps,
trills and noise bursts with cluster structure, over coloured-noise beds, at
the presets' frontend configurations) are trained with the fine-tuning
objective (timestamp decoding + frame head). ``gen_example``,
``make_items`` and ``PRETRAIN_CONFIGS`` are numpy copies of the JAX
package's: under one ``RandomState`` they give the same audio, labels and
targets, bit for bit.

The pool of examples lives on the device: ``collate_pool`` computes every
example's log-mel features there (one mel-kernel launch per chunk of a
frontend configuration), and ``build_scan_train_step`` runs K optimizer
steps per call, each gathering its batch from the pool by indices on the
device, with the losses left on the device until they are logged (the
JAX package's ``lax.scan`` is a Python loop here). The host makes the next
pool on a worker thread while the device trains.

    python -m whisperseg_torch.pretrain --model base --model_folder OUT \
        [--steps 40000] [--device cpu]

takes the flags of ``scripts/pretrain_synthetic.py``; the final checkpoint
feeds the train CLI's ``--initial_model_path``.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .checkpoint import finalize_best_checkpoint, save_training_checkpoint
from .data import FRAME_KEYS, VocalSegDataset
from .models.config import make_config
from .models.whisper import (cross_entropy_loss, decoder_forward_train,
                             encoder_forward, ensure_frame_head,
                             frame_head_forward, frame_head_loss, init_params)
from .runtime import resolve_device
from .training.trainer import (batch_to_device, build_train_step,
                               make_optimizer, training_params)


# ------------------------------------------------------------------ acoustics
#
# Each preset family of config/segment_config.json contributes a frontend
# configuration, so pretraining sees every (sr, spec_time_step,
# min_frequency) geometry a fine-tune will meet.

PRETRAIN_CONFIGS: Tuple[Tuple[int, float, float], ...] = (
    (32000, 0.0025, 0.0),     # zebra/bengalese finch preset
    (48000, 0.0025, 0.0),     # marmoset preset
    (300000, 0.0005, 35000.0),  # mouse USV preset
    (16000, 0.01, 0.0),       # human preset
    (16000, 0.001, 0.0),      # meerkat preset
    (44100, 0.005, 0.0),      # generic audio-rate corpus
)

_KINDS = ("tone", "harmonic", "chirp", "trill", "noise")


def _edge_env(n: int, sr: float, rise_s: float) -> np.ndarray:
    """Linear attack/release envelope so events have no clicks."""
    t = np.arange(n) / sr
    rise = max(rise_s, 1.0 / sr)
    return np.minimum(1.0, np.minimum(t, t[::-1] if n > 1 else t) / rise)


def _synth_event(rng: np.random.RandomState, sr: int, n: int, sig: dict) -> np.ndarray:
    """One labeled event of ``sig['kind']`` with per-event jitter."""
    t = np.arange(n) / sr
    kind = sig["kind"]
    f0 = sig["f0"] * 2.0 ** rng.uniform(-0.15, 0.15)
    dur = max(n / sr, 1e-6)
    if kind == "noise":
        spec = np.fft.rfft(rng.randn(n))
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        lo, hi = f0 / 2 ** sig["bw_oct"], f0 * 2 ** sig["bw_oct"]
        spec[(freqs < lo) | (freqs > min(hi, sr / 2))] = 0.0
        y = np.fft.irfft(spec, n)
        peak = np.abs(y).max() or 1.0
        y = y / peak
    else:
        if kind == "chirp":
            sweep_oct = sig["fm_oct"] * rng.choice([-1.0, 1.0])
            f_t = f0 * 2.0 ** (sweep_oct * t / dur)
        elif kind in ("tone", "trill"):
            f_t = f0 * 2.0 ** (sig["fm_oct"] * np.sin(
                2 * np.pi * rng.uniform(0.3, 3.0) / dur * t
                + rng.uniform(0, 2 * np.pi)))
        else:  # harmonic
            f_t = f0 * (1.0 + 0.05 * np.sin(
                2 * np.pi * rng.uniform(0.5, 4.0) * t + rng.uniform(0, 2 * np.pi)))
        phase = 2 * np.pi * np.cumsum(f_t) / sr
        if kind == "harmonic":
            y = np.zeros(n)
            for h in range(1, 13):
                if f0 * h >= 0.48 * sr:
                    break
                y += np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h
            peak = np.abs(y).max() or 1.0
            y = y / peak
        else:
            y = np.sin(phase)
        if kind == "trill":
            am_rate = sig.get("am_rate", 30.0) * rng.uniform(0.8, 1.25)
            y = y * (0.5 + 0.5 * np.square(
                np.sin(np.pi * am_rate * t + rng.uniform(0, np.pi))))
    return (y * _edge_env(n, sr, sig["rise_s"])).astype(np.float32)


def _cluster_signature(rng: np.random.RandomState, sr: int, min_frequency: float,
                       window_s: float) -> dict:
    """A stable per-cluster acoustic identity (kind + band + duration range)."""
    lo = max(0.02 * sr, min_frequency * 1.15, 200.0)
    hi = 0.38 * sr
    dur_lo = max(3.0e-3, window_s / 500.0)
    dur_hi = min(0.3 * window_s, 120 * dur_lo)
    d1 = np.exp(rng.uniform(np.log(dur_lo), np.log(dur_hi)))
    return {
        "kind": _KINDS[rng.randint(len(_KINDS))],
        "f0": float(np.exp(rng.uniform(np.log(lo), np.log(hi)))),
        "fm_oct": float(rng.uniform(0.0, 1.2)),
        "bw_oct": float(rng.uniform(0.15, 1.0)),
        "am_rate": float(np.exp(rng.uniform(np.log(8.0), np.log(80.0)))),
        "rise_s": float(np.exp(rng.uniform(np.log(5e-4), np.log(1e-2)))),
        "dur_range": (float(d1), float(min(d1 * rng.uniform(1.5, 4.0), dur_hi))),
        "amp": float(rng.uniform(0.15, 0.9)),
    }


def _background(rng: np.random.RandomState, sr: int, n: int) -> np.ndarray:
    """Colored-noise bed + occasional hum/unlabeled broadband clicks."""
    level = 10.0 ** rng.uniform(-3.3, -1.3)
    spec = np.fft.rfft(rng.randn(n))
    freqs = np.maximum(np.fft.rfftfreq(n, 1.0 / sr), 1.0)
    spec = spec / freqs ** rng.uniform(0.0, 0.8)
    y = np.fft.irfft(spec, n)
    y = level * y / (np.std(y) or 1.0)
    if sr <= 48000 and rng.rand() < 0.25:  # mains hum + harmonics
        base = rng.choice([50.0, 60.0])
        t = np.arange(n) / sr
        for h in (1, 2, 3):
            y += level * rng.uniform(0.2, 1.0) * np.sin(
                2 * np.pi * base * h * t + rng.uniform(0, 2 * np.pi))
    if rng.rand() < 0.3:  # unlabeled low-level clicks (cage noise analogue)
        for _ in range(rng.randint(1, 5)):
            pos = rng.randint(n)
            width = rng.randint(max(2, sr // 4000), max(4, sr // 400))
            hi = min(pos + width, n)
            y[pos:hi] += rng.uniform(0.01, 0.08) * rng.randn(hi - pos)
    return y.astype(np.float32)


def gen_example(rng: np.random.RandomState, sr: int, spec_time_step: float,
                min_frequency: float, total_spec_columns: int,
                max_events: int = 20, max_clusters: int = 5):
    """One synthetic clip + label at one frontend configuration.

    Returns ``(audio, label)`` shaped for :class:`~whisperseg_torch.data.
    VocalSegDataset` — the audio is ~10% longer than one training window so
    the dataset's random crop provides translation jitter."""
    window_s = total_spec_columns * spec_time_step
    n = int(round(window_s * 1.1 * sr))
    audio = _background(rng, sr, n)

    onsets: List[float] = []
    offsets: List[float] = []
    cluster_ids: List[int] = []
    if rng.rand() >= 0.08:  # 8% of clips are pure background (silence target)
        n_clusters = 1 if rng.rand() < 0.5 else rng.randint(2, max_clusters + 1)
        sigs = [_cluster_signature(rng, sr, min_frequency, window_s)
                for _ in range(n_clusters)]
        dense_train = rng.rand() < 0.35  # song-like syllable trains: tight
        # gaps (2-20 quanta) between successive events, the finch song
        # regime; without them the event channels learn a prior of
        # well-separated events that over-splits dense song
        n_events = rng.randint(1, max_events + 1)
        gap_scale = window_s / max(n_events, 1)
        cursor = rng.uniform(0.0, 0.5 * gap_scale)
        # cluster ids are numbered by order of first appearance (the first
        # event's cluster is 0, the next new signature 1, ...): a random
        # signature -> id assignment would make the decoder's cluster digits
        # unpredictable, while first-appearance order can be inferred from
        # the audio alone
        relabel: Dict[int, int] = {}
        for _ in range(n_events):
            raw_cid = rng.randint(n_clusters)
            sig = sigs[raw_cid]
            dur = float(rng.uniform(*sig["dur_range"]))
            if cursor + dur >= n / sr:
                break
            a, b = int(cursor * sr), int((cursor + dur) * sr)
            if b - a >= 8:
                audio[a:b] += sig["amp"] * rng.uniform(0.6, 1.2) * _synth_event(
                    rng, sr, b - a, sig)
                onsets.append(cursor)
                offsets.append(cursor + dur)
                cluster_ids.append(relabel.setdefault(raw_cid, len(relabel)))
            if dense_train:
                gap = float(np.exp(rng.uniform(np.log(2.0), np.log(20.0)))
                            ) * spec_time_step
            else:
                gap = max(2.5 * spec_time_step,
                          float(rng.exponential(0.6 * gap_scale)))
            cursor += dur + gap
    label = {
        "species": "unknown",
        "sr": sr,
        "spec_time_step": spec_time_step,
        "min_frequency": min_frequency,
        "onset": np.asarray(onsets, dtype=np.float64),
        "offset": np.asarray(offsets, dtype=np.float64),
        "cluster_id": np.asarray(cluster_ids, dtype=np.int64),
        "cluster": [str(c) for c in cluster_ids],
    }
    peak = np.abs(audio).max()
    if peak > 1.0:
        audio /= peak
    return audio, label


# ------------------------------------------------------------------ pool build


@dataclass
class PoolSpec:
    total_spec_columns: int = 1000
    max_length: int = 100
    frame_sigma: float = 1.0
    configs: Tuple[Tuple[int, float, float], ...] = PRETRAIN_CONFIGS
    chunk: int = 64  # examples a configuration contributes per collate call


def make_items(seed: int, n_items: int, spec: PoolSpec, device=None):
    """Host half of a pool refresh: synthetic audio and tokenized targets,
    ``[(dataset, items)]`` one per configuration. ``n_items`` is rounded up
    to a multiple of ``len(configs) * chunk``. ``device`` is where the
    datasets collate (the card unless "cpu")."""
    per = -(-n_items // (len(spec.configs) * spec.chunk)) * spec.chunk
    rng = np.random.RandomState(seed)
    items_by_config = []
    for (sr, step, minf) in spec.configs:
        audio_list, label_list = [], []
        for _ in range(per):
            a, l = gen_example(rng, sr, step, minf, spec.total_spec_columns)
            audio_list.append(a)
            label_list.append(l)
        ds = VocalSegDataset(audio_list, label_list, spec.max_length,
                             spec.total_spec_columns, frame_targets=True,
                             frame_sigma=spec.frame_sigma, device=device)
        items = [ds.__getitem__(i, rng=rng) for i in range(per)]
        items_by_config.append((ds, items))
    return items_by_config


def collate_pool(items_by_config, spec: PoolSpec) -> Dict[str, object]:
    """Device half of a pool refresh: every example's log-mel features on
    the datasets' device, one collate (one mel-kernel launch) per chunk of a
    configuration, and the ids, labels and frame targets as tensors there
    (``trainer.batch_to_device``'s types)."""
    return stack_batches([ds.collate(items[i:i + spec.chunk])
                          for ds, items in items_by_config
                          for i in range(0, len(items), spec.chunk)])


def stack_batches(batches) -> Dict[str, object]:
    """Collated batches (``VocalSegDataset.collate``'s) as one pool of
    tensors on their features' device, rows in the batches' order."""
    pool = {"input_features": torch.cat([b["input_features"] for b in batches])}
    for k in ("decoder_input_ids", "labels"):
        pool[k] = np.concatenate([b[k] for b in batches])
    if "frame_targets" in batches[0]:
        pool["frame_targets"] = {
            k: np.concatenate([b["frame_targets"][k] for b in batches])
            for k in FRAME_KEYS}
    return batch_to_device(pool, pool["input_features"].device)


def _gather(tree: dict, idx: torch.Tensor) -> dict:
    """Rows ``idx`` of every tensor of a (nested) pool, on its device."""
    return {k: _gather(v, idx) if isinstance(v, dict) else v.index_select(0, idx)
            for k, v in tree.items()}


# ------------------------------------------------------------- scanned trainer


def build_scan_train_step(cfg, optimizer, scheduler, steps_per_call: int,
                          batch_size: int,
                          timestamp_loss_weight: float = 1.0,
                          timestamp_label_sigma: float = 1.0,
                          use_spec_augment: bool = True,
                          frame_head_weight: float = 2.0,
                          frame_boundary_weight: float = 1.0,
                          qat_bits: int = 0):
    """``multi_step(params, pool, idx, gen) -> losses``: one optimizer step
    (``trainer.build_train_step``'s, with these options) per row of ``idx``
    [K, batch_size], an integer tensor on the pool's device whose rows index
    the pool's leading axis; up to ``steps_per_call`` rows. The batches are
    gathered on the device and the K losses come back as one device tensor,
    so the host never waits inside a call. ``frame_head_weight <= 0`` trains
    without frame targets."""
    step = build_train_step(
        cfg, optimizer, scheduler, qat_bits=qat_bits,
        timestamp_loss_weight=timestamp_loss_weight,
        timestamp_label_sigma=timestamp_label_sigma,
        use_spec_augment=use_spec_augment,
        frame_head_weight=frame_head_weight,
        frame_boundary_weight=frame_boundary_weight)

    def multi_step(params, pool, idx: torch.Tensor,
                   gen: torch.Generator) -> torch.Tensor:
        if idx.dim() != 2 or idx.shape[0] > steps_per_call \
                or idx.shape[1] != batch_size:
            raise ValueError(f"idx must be [<= {steps_per_call}, "
                             f"{batch_size}], got {tuple(idx.shape)}")
        return torch.stack([step(params, _gather(pool, row), gen)
                            for row in idx])

    return multi_step


def build_eval_loss(cfg, timestamp_loss_weight: float = 1.0,
                    timestamp_label_sigma: float = 1.0,
                    frame_head_weight: float = 2.0,
                    frame_boundary_weight: float = 1.0):
    """``loss_fn(params, batch)``: the loss of one batch without dropout or
    augmentation and without gradients, as a device scalar."""
    @torch.no_grad()
    def loss_fn(params, batch):
        enc = encoder_forward(params, cfg, batch["input_features"])
        logits = decoder_forward_train(params, cfg, enc,
                                       batch["decoder_input_ids"])
        loss = cross_entropy_loss(logits, batch["labels"],
                                  timestamp_weight=timestamp_loss_weight,
                                  timestamp_sigma=timestamp_label_sigma)
        floss = frame_head_loss(frame_head_forward(params, cfg, enc),
                                batch["frame_targets"],
                                boundary_weight=frame_boundary_weight)
        return loss + frame_head_weight * floss

    return loss_fn


# ----------------------------------------------------------------- entry point


@dataclass
class PretrainArgs:
    model: str = "base"
    model_folder: str = "pretrain_model"
    steps: int = 40000
    batch_size: int = 8
    pool_items: int = 1536
    refresh_every: int = 2500
    steps_per_call: int = 100
    learning_rate: float = 5e-4
    weight_decay: float = 0.01
    warmup_steps: int = 500
    dropout: float = 0.1
    seed: int = 0
    max_clusters: int = 5
    save_every: int = 10000
    spec: PoolSpec = field(default_factory=PoolSpec)
    device: Optional[str] = None  # the card unless "cpu" is asked for


def _slice(tree: dict, a: int, b: int) -> dict:
    return {k: _slice(v, a, b) if isinstance(v, dict) else v[a:b]
            for k, v in tree.items()}


def run_pretraining(args: PretrainArgs,
                    use_spec_augment: bool = False) -> Optional[str]:
    """Pretrain a fresh ``args.model`` (with a frame head of
    ``max_clusters`` clusters) on refreshed synthetic pools; returns the
    ``final_checkpoint`` path. Every ``refresh_every`` steps (and at the
    end) the host reads the losses, logs them with the loss of a held-out
    synthetic pool, and swaps in the pool its worker thread made meanwhile.
    SpecAugment is off by default: the refreshed pools give fresh data, and
    masked stripes whose events the labels still ask for only corrupt the
    decoder's task."""
    device = resolve_device(args.device)
    os.makedirs(args.model_folder, exist_ok=True)
    spec = args.spec
    cfg = make_config(args.model, total_spec_columns=spec.total_spec_columns,
                      dropout=args.dropout)
    cfg.frame_head = True
    cfg.frame_head_clusters = args.max_clusters
    params = init_params(torch.Generator().manual_seed(args.seed), cfg)
    params = ensure_frame_head(
        params, cfg, torch.Generator().manual_seed(args.seed ^ 0x5E6))
    params = training_params(params, device)

    optimizer, scheduler, schedule = make_optimizer(
        params, args.learning_rate, args.weight_decay, args.warmup_steps,
        args.steps, "linear", freeze_encoder=False)
    train_k = build_scan_train_step(cfg, optimizer, scheduler,
                                    args.steps_per_call, args.batch_size,
                                    use_spec_augment=use_spec_augment)
    eval_loss = build_eval_loss(cfg)
    gen = torch.Generator().manual_seed(args.seed + 1)
    host_rng = np.random.RandomState(args.seed + 2)

    # a held-out synthetic pool, one chunk a configuration, for a val loss
    # that is comparable across refreshes
    val_pool = collate_pool(make_items(args.seed + 999_983,
                                       len(spec.configs) * spec.chunk, spec,
                                       device), spec)
    n_val = int(val_pool["labels"].shape[0])
    metrics_path = os.path.join(args.model_folder, "metrics.jsonl")

    # double-buffered refresh: items made on a worker thread, collated on
    # the device between calls
    next_items: List = [None]

    def refresh_worker(seed):
        next_items[0] = make_items(seed, args.pool_items, spec, device)

    refresh_worker(args.seed + 10)  # the first pool is made while we wait
    pool = collate_pool(next_items[0], spec)
    n_pool = int(pool["labels"].shape[0])
    t_gen = threading.Thread(target=refresh_worker, args=(args.seed + 11,))
    t_gen.start()

    step, refresh_id = 0, 2
    t0 = time.time()
    try:
        while step < args.steps:
            k = min(args.steps_per_call, args.steps - step)
            idx = host_rng.randint(0, n_pool, size=(args.steps_per_call,
                                                    args.batch_size))
            losses = train_k(params, pool,
                             torch.from_numpy(idx[:k]).to(device), gen)
            step += k
            if step % args.refresh_every < args.steps_per_call \
                    or step >= args.steps:
                vloss = float(torch.stack([
                    eval_loss(params, _slice(val_pool, i, i + args.batch_size))
                    for i in range(0, n_val, args.batch_size)][:8]).mean())
                rate = step / max(time.time() - t0, 1e-9)
                rec = {"current_step": step,
                       "train/loss": float(losses.mean()),
                       "val/loss": vloss, "perf/steps_per_s": round(rate, 2),
                       "train/learning_rate": float(schedule(step))}
                print(json.dumps(rec), flush=True)
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                if step < args.steps:
                    t_gen.join()
                    pool = collate_pool(next_items[0], spec)
                    n_pool = int(pool["labels"].shape[0])
                    t_gen = threading.Thread(
                        target=refresh_worker,
                        args=(args.seed + 10 + refresh_id,))
                    t_gen.start()
                    refresh_id += 1
            if step % args.save_every < args.steps_per_call \
                    or step >= args.steps:
                save_training_checkpoint(args.model_folder, params, cfg, step,
                                         max_to_keep=2, keep_step=None)
    finally:
        t_gen.join()
    final = finalize_best_checkpoint(args.model_folder, None)
    if final:
        print(f"Final checkpoint: {final}", flush=True)
    return final


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="base")
    ap.add_argument("--model_folder", required=True)
    ap.add_argument("--steps", type=int, default=40000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--pool_items", type=int, default=1536)
    ap.add_argument("--refresh_every", type=int, default=2500)
    ap.add_argument("--steps_per_call", type=int, default=100)
    ap.add_argument("--learning_rate", type=float, default=5e-4)
    ap.add_argument("--warmup_steps", type=int, default=500)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_clusters", type=int, default=5)
    ap.add_argument("--save_every", type=int, default=10000)
    ap.add_argument("--total_spec_columns", type=int, default=1000)
    ap.add_argument("--max_length", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card unless 'cpu' is given")
    a = ap.parse_args(argv)
    spec = PoolSpec(total_spec_columns=a.total_spec_columns,
                    max_length=a.max_length)
    return run_pretraining(PretrainArgs(
        model=a.model, model_folder=a.model_folder, steps=a.steps,
        batch_size=a.batch_size, pool_items=a.pool_items,
        refresh_every=a.refresh_every, steps_per_call=a.steps_per_call,
        learning_rate=a.learning_rate, warmup_steps=a.warmup_steps,
        dropout=a.dropout, seed=a.seed, max_clusters=a.max_clusters,
        save_every=a.save_every, spec=spec, device=a.device))


if __name__ == "__main__":
    main()
