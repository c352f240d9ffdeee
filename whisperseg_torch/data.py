"""Training data: discovery, labels, default configuration, slicing, targets
and batching (the port of ``whisperseg_tpu/data.py``).

Everything random draws on the global ``np.random`` stream in the JAX
package's order, so the same seed gives the same crops and the same batch
order in both packages. ``VocalSegDataset.collate`` computes a batch's
log-mel features with the port's ``Frontend`` on the training device: one
mel-kernel launch per frontend configuration in the batch.
"""

from __future__ import annotations

import csv
import json
import os
import threading
from collections import Counter
from copy import deepcopy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import codec, profiling
from .audio.frontend import Frontend
from .audio.io import get_audio_duration, get_sampling_rate, load_audio
from .constants import NUM_MEL_BINS, fft_time_delta
from .constants import RATIO_DECODING_TIME_STEP_TO_SPEC_TIME_STEP as RATIO

# ----------------------------------------------------------------------- labels


def _read_csv(path: str) -> dict:
    """Columns of a CSV label file, each typed as a whole: int where every
    cell is an integer, else float where every cell is a number, else str."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    out = {}
    for key in (rows[0].keys() if rows else []):
        cells = [r[key] for r in rows]
        for cast in (int, float, str):
            try:
                out[key] = [cast(c) for c in cells]
                break
            except ValueError:
                continue
    return out


def read_label(label_path: str, default_config: Optional[dict] = None,
               ignore_cluster: bool = False) -> dict:
    """Load a .json/.csv annotation; keys the label lacks come from
    ``default_config``."""
    default_config = default_config or {}
    if label_path.endswith(".json"):
        with open(label_path) as f:
            label = json.load(f)
    elif label_path.endswith(".csv"):
        label = _read_csv(label_path)
    else:
        raise ValueError(f"Unsupported label format: {label_path}")
    assert "onset" in label and "offset" in label
    if "cluster" not in label:
        label["cluster"] = ["Vocal"] * len(label["onset"])
    label["cluster"] = list(map(str, label["cluster"]))
    for k, v in default_config.items():
        if k not in label:
            label[k] = v
    label["species"] = "unknown"  # not used downstream
    if ignore_cluster:
        label["cluster"] = ["Vocal"] * len(label["cluster"])
    return label


_AUDIO_EXTS = (".wav", ".flac", ".mp3", ".ogg")


def get_audio_and_label_paths(folder: str) -> Tuple[List[str], List[str]]:
    """Pair audio files with sibling .json (preferred) or .csv labels."""
    audio_paths, label_paths = [], []
    for fname in os.listdir(folder):
        ext = os.path.splitext(fname)[1].lower()
        if ext not in _AUDIO_EXTS:
            continue
        audio = os.path.join(folder, fname)
        stem = audio[: -len(ext)]
        for label_ext in (".json", ".csv"):
            if os.path.exists(stem + label_ext):
                audio_paths.append(audio)
                label_paths.append(stem + label_ext)
                break
    return audio_paths, label_paths


def determine_default_config(audio_paths: Sequence[str], label_paths: Sequence[str],
                             total_spec_columns: int,
                             ignore_cluster: bool = False,
                             labels: Optional[Sequence[dict]] = None) -> dict:
    """(sr, spec_time_step, ...) derived from the dataset: the median
    sampling rate, and a step that fits about 25 median segment durations,
    rounded up to 0.5 s, in one window. ``labels``: already parsed
    ``read_label`` dicts in the paths' order."""
    sr_list = [get_sampling_rate(p) for p in audio_paths]
    assert len(sr_list) > 0, "No valid audios were provided."
    sr = int(np.median(sr_list))
    time_delta = fft_time_delta(sr)
    if labels is None:
        labels = [read_label(p, ignore_cluster=ignore_cluster)
                  for p in label_paths]
    onsets, offsets = [], []
    for audio_path, label in zip(audio_paths, labels):
        dur = get_audio_duration(audio_path)
        onsets += [max(0, t - time_delta) for t in label["onset"]]
        offsets += [min(dur, t + time_delta) for t in label["offset"]]
    assert len(onsets) > 0, "No vocal segment is annotated in the label files."
    seg_dur_median = float(np.median(np.asarray(offsets) - np.asarray(onsets)))
    spec_time_step = float(
        np.ceil(seg_dur_median * 25 / 0.5) * 0.5 / total_spec_columns)
    return {"species": "unknown", "sr": sr, "min_frequency": 0,
            "spec_time_step": spec_time_step}


def resolve_default_config(audio_paths: Sequence[str], label_paths: Sequence[str],
                           total_spec_columns: int,
                           ignore_cluster: bool = False) -> dict:
    """``determine_default_config``, except that a key every label states
    (``sr``, ``min_frequency``, ``spec_time_step``) takes the labels' most
    common value (ties toward the median, then the smaller value): the value
    training actually used."""
    labels = [read_label(p, ignore_cluster=ignore_cluster) for p in label_paths]
    config = determine_default_config(audio_paths, label_paths,
                                      total_spec_columns,
                                      ignore_cluster=ignore_cluster,
                                      labels=labels)
    for key, cast in (("sr", int), ("min_frequency", float),
                      ("spec_time_step", float)):
        explicit = [lab[key] for lab in labels if key in lab]
        if labels and len(explicit) == len(labels):
            med = float(np.median(np.asarray(explicit, dtype=np.float64)))
            counts = Counter(explicit)
            best = max(counts, key=lambda v: (counts[v], -abs(v - med), -v))
            config[key] = cast(best)
    return config


def get_cluster_codebook(label_paths: Sequence[str], initial_cluster_codebook: dict,
                         ignore_cluster: bool = False) -> dict:
    """Sorted unique cluster names -> ids, extending an initial codebook."""
    codebook = deepcopy(initial_cluster_codebook)
    unique = set()
    for path in label_paths:
        unique.update(read_label(path, ignore_cluster=ignore_cluster)["cluster"])
    for cluster in sorted(unique):
        if cluster not in codebook:
            codebook[cluster] = len(codebook)
    return codebook


# ---------------------------------------------------------------------- loading


def _load_one(audio_path: str, label_path: str, cluster_codebook: dict,
              default_config: dict, ignore_cluster: bool):
    label = read_label(label_path, default_config, ignore_cluster=ignore_cluster)
    sr = label["sr"]
    y, _ = load_audio(audio_path, sr=sr)
    time_delta = fft_time_delta(sr)
    dur = len(y) / sr
    # widen each segment by the FFT window's half-width (the blur the
    # segmenter undoes on its output), then drop segments outside the audio
    onset = np.asarray([max(0, t - time_delta) for t in label["onset"]])
    offset = np.asarray([min(dur, t + time_delta) for t in label["offset"]])
    valid = (onset < dur) & (offset > 0) & (onset <= offset)
    onset, offset = onset[valid], offset[valid]
    label["cluster"] = [c for c, v in zip(label["cluster"], valid) if v]
    label.update({
        "onset": onset,
        "offset": offset,
        "cluster_id": np.asarray([cluster_codebook[c] for c in label["cluster"]],
                                 dtype=np.int64),
    })
    return y, label


def load_data(audio_paths: Sequence[str], label_paths: Sequence[str],
              cluster_codebook: dict, n_threads: int = 8,
              default_config: Optional[dict] = None,
              ignore_cluster: bool = False):
    """Threaded corpus load; a file that fails names itself."""
    default_config = default_config or {}
    n = len(audio_paths)
    results: List = [None] * n
    lock = threading.Lock()
    next_idx = [0]

    def worker():
        while True:
            with lock:
                if next_idx[0] >= n:
                    return
                i = next_idx[0]
                next_idx[0] += 1
            try:
                results[i] = _load_one(audio_paths[i], label_paths[i],
                                       cluster_codebook, default_config,
                                       ignore_cluster)
            except Exception as e:  # surfaced below, naming the file
                results[i] = e

    threads = [threading.Thread(target=worker)
               for _ in range(min(n_threads, max(n, 1)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failures = [(audio_paths[i], r) for i, r in enumerate(results)
                if isinstance(r, Exception)]
    if failures:
        path, err = failures[0]
        raise RuntimeError(
            f"failed to load {len(failures)} of {n} training file(s); "
            f"first failure: {path}: {type(err).__name__}: {err}") from err
    return [r[0] for r in results], [r[1] for r in results]


# ---------------------------------------------------------------------- splits


def split_audio_and_label(audio, label, split_ratio: float):
    """Head/tail split of one file, segments clipped at the cut; a part
    shorter than 0.1 s becomes (None, None)."""
    sr = label["sr"]
    split_point = int(len(audio) * split_ratio)
    split_time = split_point / sr

    def part(seg_audio, onset, offset, cluster_id, cluster):
        if len(seg_audio) / sr < 0.1:
            return None, None
        p = deepcopy(label)
        p.update({"onset": onset, "offset": offset, "cluster_id": cluster_id,
                  "cluster": cluster})
        return seg_audio, p

    idx1 = label["onset"] < split_time
    part1 = part(audio[:split_point], label["onset"][idx1],
                 np.minimum(label["offset"][idx1], split_time),
                 label["cluster_id"][idx1],
                 [label["cluster"][i] for i in np.nonzero(idx1)[0]])
    idx2 = label["offset"] > split_time
    part2 = part(audio[split_point:],
                 np.maximum(label["onset"][idx2], split_time) - split_time,
                 label["offset"][idx2] - split_time,
                 label["cluster_id"][idx2],
                 [label["cluster"][i] for i in np.nonzero(idx2)[0]])
    return part1, part2


def train_val_split(audio_list, label_list, val_ratio: float):
    """Per file, a random head or tail of ``val_ratio`` goes to validation."""
    train_a, train_l, val_a, val_l = [], [], [], []
    for audio, label in zip(audio_list, label_list):
        if np.random.choice([0, 1]) == 0:
            (va, vl), (ta, tl) = split_audio_and_label(audio, label, val_ratio)
        else:
            (ta, tl), (va, vl) = split_audio_and_label(audio, label, 1 - val_ratio)
        if ta is not None:
            train_a.append(ta)
            train_l.append(tl)
        if va is not None:
            val_a.append(va)
            val_l.append(vl)
    return (train_a, train_l), (val_a, val_l)


def slice_audio_and_label(audio, label, total_spec_columns: int):
    """Chop one file into windows of two clips, one clip apart, after a
    one-clip zero left pad."""
    sr = label["sr"]
    clip_duration = total_spec_columns * label["spec_time_step"]
    num_samples = int(np.round(clip_duration * sr))
    padded = np.concatenate([np.zeros(num_samples, dtype=audio.dtype), audio])
    p_onset = label["onset"] + clip_duration
    p_offset = label["offset"] + clip_duration
    audio_clips, label_clips = [], []
    for pos in range(0, len(padded), num_samples):
        clip = padded[pos:pos + 2 * num_samples]
        if len(clip) / sr < 0.1:
            continue
        start, end = pos / sr, (pos + len(clip)) / sr
        inter = (p_onset < end) & (p_offset > start)
        lc = deepcopy(label)
        lc.update({
            "onset": np.maximum(p_onset[inter], start) - start,
            "offset": np.minimum(p_offset[inter], end) - start,
            "cluster_id": label["cluster_id"][inter],
            "cluster": [label["cluster"][i] for i in np.nonzero(inter)[0]],
        })
        audio_clips.append(clip)
        label_clips.append(lc)
    return audio_clips, label_clips


def slice_audios_and_labels(audio_list, label_list, total_spec_columns: int):
    sliced_a, sliced_l = [], []
    for audio, label in zip(audio_list, label_list):
        a, l = slice_audio_and_label(audio, label, total_spec_columns)
        sliced_a += a
        sliced_l += l
    return sliced_a, sliced_l


# ---------------------------------------------------------------------- dataset


def build_frame_targets(onsets, offsets, cluster_ids, spec_time_step: float,
                        total_spec_columns: int, sigma: float = 1.0):
    """Per-encoder-position targets of the frame head on the decoder's time
    base (``S = total_spec_columns // 2`` positions of ``spec_time_step *
    RATIO`` seconds): ``vocal`` [S] 0/1, ``onset`` / ``offset`` [S] soft
    event tracks (the max of per-event Gaussians of stddev ``sigma``
    positions), ``cluster`` [S] int32 (-1 where unlabelled)."""
    S = total_spec_columns // 2
    quantum = spec_time_step * RATIO
    vocal = np.zeros(S, dtype=np.float32)
    onset_evt = np.zeros(S, dtype=np.float32)
    offset_evt = np.zeros(S, dtype=np.float32)
    cluster = np.full(S, -1, dtype=np.int32)
    grid = np.arange(S, dtype=np.float32)
    for on, off, cid in zip(onsets, offsets, cluster_ids):
        c_on = min(int(np.round(float(on) / quantum)), S - 1)
        c_off = max(min(int(np.round(float(off) / quantum)), S), c_on + 1)
        vocal[c_on:c_off] = 1.0
        cluster[c_on:c_off] = int(cid)
        for track, c in ((onset_evt, c_on), (offset_evt, min(c_off, S - 1))):
            if sigma > 0:
                np.maximum(track, np.exp(-0.5 * ((grid - c) / sigma) ** 2),
                           out=track)
            else:
                track[c] = 1.0
    return {"vocal": vocal, "onset": onset_evt, "offset": offset_evt,
            "cluster": cluster}


FRAME_KEYS = ("vocal", "onset", "offset", "cluster")


class VocalSegDataset:
    """Random-crop training dataset. ``__getitem__`` returns host arrays;
    :meth:`collate` computes the batch's features on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, audio_list, label_list, max_length: int,
                 total_spec_columns: int, extra_token_ids: dict = None,
                 frame_targets: bool = False, frame_sigma: float = 1.0,
                 cluster_encodings: dict = None, device=None):
        from .runtime import resolve_device

        self.audio_list = audio_list
        self.label_list = label_list
        self.max_length = max_length
        self.total_spec_columns = total_spec_columns
        self.extra_token_ids = extra_token_ids or None
        self.cluster_encodings = cluster_encodings or None
        self.frame_targets = frame_targets
        self.frame_sigma = frame_sigma
        self.device = resolve_device(device)
        self._frontends: Dict[Tuple, Frontend] = {}

    def __len__(self):
        return len(self.audio_list)

    def frontend_for(self, label) -> Frontend:
        key = (label["sr"], label["spec_time_step"], label.get("min_frequency", 0))
        if key not in self._frontends:
            self._frontends[key] = Frontend(key[0], key[1], key[2] or 0)
        return self._frontends[key]

    def __getitem__(self, idx: int, rng=None):
        """A random crop of item ``idx`` with its targets. ``rng``: the
        item's own generator (the DataLoader draws one per item); without it
        the global stream."""
        audio = self.audio_list[idx]
        label = self.label_list[idx]
        sr = label["sr"]
        step = label["spec_time_step"]
        frontend = self.frontend_for(label)

        num_samples = int(np.round(self.total_spec_columns * step * sr))
        hi = min(num_samples + 1, len(audio) - frontend.n_fft + 1)
        clip_start = int((rng or np.random).choice(max(hi, 1)))
        clip = audio[clip_start:clip_start + num_samples]

        start = clip_start / sr
        end = start + len(clip) / sr
        inter = (label["onset"] < end) & (label["offset"] > start)
        onset = np.maximum(label["onset"][inter], start) - start
        offset = np.minimum(label["offset"][inter], end) - start
        cluster_id = label["cluster_id"][inter]

        target = codec.build_target_ids(
            label.get("species", "unknown"), onset, offset, cluster_id,
            step, self.total_spec_columns,
            extra_token_ids=self.extra_token_ids,
            cluster_encodings=self.cluster_encodings)
        dec_inputs, labels = codec.shift_for_training(target, self.max_length)

        full = np.zeros(num_samples, dtype=np.float32)
        full[: len(clip)] = clip
        item = {
            "audio_clip": full,
            "frontend_key": (sr, step, label.get("min_frequency", 0)),
            "decoder_input_ids": np.asarray(dec_inputs, dtype=np.int32),
            "labels": np.asarray(labels, dtype=np.int32),
        }
        if self.frame_targets:
            item["frame_targets"] = build_frame_targets(
                onset, offset, cluster_id, step, self.total_spec_columns,
                sigma=self.frame_sigma)
        return item

    def collate(self, items) -> Dict[str, object]:
        """A batch: ``input_features`` [B, 80, total_spec_columns] float32 on
        the dataset's device, one frontend call per frontend configuration;
        the ids, labels and frame targets as numpy arrays."""
        feats = torch.empty((len(items), NUM_MEL_BINS, self.total_spec_columns),
                            dtype=torch.float32, device=self.device)
        by_key: Dict[Tuple, List[int]] = {}
        for i, item in enumerate(items):
            by_key.setdefault(item["frontend_key"], []).append(i)
        for key, idxs in by_key.items():
            clips = torch.from_numpy(np.stack([items[i]["audio_clip"]
                                               for i in idxs])).to(self.device)
            feats[idxs] = self._frontends[key].features_for_clips(
                clips, self.total_spec_columns)
        batch = {
            "input_features": feats,
            "decoder_input_ids": np.stack([it["decoder_input_ids"] for it in items]),
            "labels": np.stack([it["labels"] for it in items]),
        }
        if self.frame_targets:
            batch["frame_targets"] = {
                k: np.stack([it["frame_targets"][k] for it in items])
                for k in FRAME_KEYS}
        return batch


class DataLoader:
    """Shuffled, optionally drop-last batch iterator with background prefetch.

    ``num_workers`` threads load items; the producer draws one crop
    generator per item from the global ``np.random`` stream in a fixed order
    before handing items to workers, so seeded epochs are the same for any
    ``num_workers``. Batches are bucketed by frontend configuration; the
    leftovers of the buckets form (possibly mixed) tail batches, and a short
    batch comes last. The consumer's wait for each batch is the span
    ``train.data_wait``."""

    def __init__(self, dataset: VocalSegDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 prefetch: int = 2, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)

    def _batch_indices(self):
        by_key: Dict[Tuple, List[int]] = {}
        for i, label in enumerate(self.dataset.label_list):
            key = (label["sr"], label["spec_time_step"],
                   label.get("min_frequency", 0))
            by_key.setdefault(key, []).append(i)
        batches: List[np.ndarray] = []
        leftovers: List[int] = []
        for idxs in by_key.values():
            order = np.asarray(idxs)
            if self.shuffle:
                np.random.shuffle(order)
            full = len(order) // self.batch_size * self.batch_size
            batches.extend(np.split(order[:full], full // self.batch_size)
                           if full else [])
            leftovers.extend(order[full:].tolist())
        for b in range(0, len(leftovers), self.batch_size):
            tail = np.asarray(leftovers[b:b + self.batch_size])
            if len(tail) == self.batch_size or not self.drop_last:
                batches.append(tail)
        if self.shuffle:
            np.random.shuffle(batches)
        batches.sort(key=lambda x: len(x) < self.batch_size)
        return batches

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        import queue
        from concurrent.futures import ThreadPoolExecutor

        batches = self._batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        # The consumer may abandon the iterator mid-epoch; the stop event and
        # the finally below release the producer then.
        stop = threading.Event()

        def _put(batch) -> bool:
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # an exception in __getitem__ or collate is handed to the
            # consumer, which raises it
            try:
                def seeded(idxs):
                    return [np.random.RandomState(np.random.randint(2 ** 31))
                            for _ in idxs]

                def get(i, r):
                    return self.dataset.__getitem__(int(i), rng=r)

                pool = (ThreadPoolExecutor(self.num_workers)
                        if self.num_workers > 1 else None)
                try:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        rngs = seeded(idxs)
                        if pool is None:
                            items = [get(i, r) for i, r in zip(idxs, rngs)]
                        else:
                            items = list(pool.map(get, idxs, rngs))
                        if not _put(self.dataset.collate(items)):
                            return
                finally:
                    if pool is not None:
                        pool.shutdown()
                _put(None)
            except BaseException as e:  # noqa: BLE001 - relayed to the consumer
                _put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with profiling.span("train.data_wait"):
                    batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30)
