"""Continuous cross-request window batching for serving (the port of
``whisperseg_tpu/services/batching.py``).

One worker thread drains a queue of window-work items, groups the items that
share a (frontend, decode-parameter) signature into fused device batches of
up to ``max_batch_size`` windows, and hands each request its token lists back
as soon as its own windows are decoded.

``BatchingSegmenter`` is a drop-in ``Segmenter`` (``mesh=`` included):
``segment()`` keeps its semantics (slicing, parsing and consolidation run on the calling thread);
only the device-facing ``_generate_tokens`` goes through the shared batcher.
A request that also needs the frame head's tracks (every default request on
the shipped checkpoints, whose fitted frame post-processing is on) is not
fused: it runs on the caller's thread, as in the JAX package, so that its
table does not depend on what else is in flight.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..audio.frontend import Frontend
from ..decode import samples
from ..segmenter import Segmenter, _pad_rows


@dataclass
class _WorkItem:
    clips: np.ndarray                      # [n, clip_samples]
    key: Tuple                             # batching signature
    frontend: Frontend
    max_length: int
    num_beams: int
    length_penalty: float
    int8_kv: bool
    top_k: int
    top_p: float
    seed: int
    constrained: bool
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[object] = None
    error: Optional[BaseException] = None


class BatchingSegmenter(Segmenter):
    """Segmenter with a continuous cross-request window batcher.
    ``fused_batches`` counts the device batches its worker has run;
    ``close()`` stops the worker, which holds the segmenter (and its device
    weights) until then."""

    def __init__(self, *args, max_batch_size: int = 32,
                 max_wait_ms: float = 5.0, min_bucket: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        # a device batch is padded to the smallest power-of-two bucket >= its
        # real window count (at least min_bucket, at most max_batch_size), so
        # that a lightly fused group runs a narrower decode
        self.min_bucket = min_bucket
        self.fused_batches = 0
        self._queue: "queue.Queue[Optional[_WorkItem]]" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _bucket(self, n: int) -> int:
        b = max(self.min_bucket, 1)
        if self.mesh is not None:
            # a batch split by rows must divide over the mesh's devices
            b = max(b, self.mesh.size)
        while b < n:
            b *= 2
        return min(b, self.max_batch_size)

    def close(self) -> None:
        """Stop the worker once the requests queued before this call are
        answered; a later request raises."""
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            self._worker.join()

    # --------------------------------------------------------------- requests

    def _generate_tokens(self, clips, frontend, batch_size, max_length,
                         num_beams, length_penalty, status_monitor=None,
                         collect_frames=False, int8_kv=False, top_k=1,
                         top_p=1.0, seed=0, constrained=False):
        if self._closed:
            raise RuntimeError("the BatchingSegmenter is closed")
        if collect_frames:
            # the caller's thread, in batches of the request's own size: the
            # JAX batcher's rule for requests that need the frame tracks
            return super()._generate_tokens(
                clips, frontend, batch_size, max_length, num_beams,
                length_penalty, status_monitor, collect_frames=True,
                int8_kv=int8_kv, top_k=top_k, top_p=top_p, seed=seed,
                constrained=constrained)
        # the worker decodes a fused group with the head item's seed, so two
        # sampled requests with different seeds must not share a group;
        # greedy requests ignore the seed and may
        key = (frontend.sr, frontend.spec_time_step, frontend.min_frequency,
               frontend.max_frequency, clips.shape[1], max_length, num_beams,
               top_k, float(length_penalty), constrained, int8_kv,
               float(top_p), seed if samples(top_k, top_p) else 0)
        item = _WorkItem(np.asarray(clips, np.float32), key, frontend,
                         max_length, num_beams, float(length_penalty), int8_kv,
                         top_k, float(top_p), seed, constrained)
        self._queue.put(item)
        item.done.wait()
        if item.error is not None:
            raise item.error
        if status_monitor is not None:
            status_monitor["progress"] = 100
        return item.result

    # ----------------------------------------------------------------- worker

    def _collect(self) -> Optional[List[_WorkItem]]:
        """One head item, then same-key items until the batch is full or the
        wait window closes; None once ``close()`` has queued its stop."""
        head = self._queue.get()
        if head is None:
            return None
        group = [head]
        total = head.clips.shape[0]
        while total < self.max_batch_size:
            try:
                nxt = self._queue.get(timeout=self.max_wait_ms / 1000.0)
            except queue.Empty:
                break
            if nxt is None or nxt.key != head.key:
                # the stop or another signature: back in the queue for the
                # next round
                self._queue.put(nxt)
                break
            group.append(nxt)
            total += nxt.clips.shape[0]
        return group

    def _run(self):
        while (group := self._collect()) is not None:
            self._decode_group(group)

    def _decode_group(self, group: List[_WorkItem]) -> None:
        head = group[0]
        try:
            clips = np.concatenate([it.clips for it in group], axis=0)
            n = clips.shape[0]
            # each item's [start, start + len) slice of the fused axis
            starts = np.cumsum([0] + [it.clips.shape[0] for it in group])
            tokens: List[List[int]] = []

            def release_ready():
                # an item whose windows are all decoded returns to its waiter
                # now: its parsing overlaps the group's remaining device time
                for it, s in zip(group, starts):
                    k = it.clips.shape[0]
                    if not it.done.is_set() and s + k <= len(tokens):
                        it.result = tokens[s:s + k]
                        it.done.set()

            noise = self._sampling_noise(head.seed, head.top_k, head.top_p)
            pos = 0
            while pos < n:
                real = min(n - pos, self.max_batch_size)
                batch = self._bucket(real)
                real = min(real, batch)
                out = self._decode_batch(
                    _pad_rows(clips[pos:pos + real], batch), head.frontend,
                    head.max_length, head.num_beams, head.length_penalty,
                    head.int8_kv, head.top_k, head.top_p, head.constrained,
                    noise, real=real)
                self.fused_batches += 1
                tokens += out[:real].cpu().tolist()
                pos += real
                release_ready()
        except BaseException as e:  # every waiter still waiting gets it
            for it in group:
                if not it.done.is_set():
                    it.error = e
                    it.done.set()
            if not isinstance(e, Exception):
                raise
