"""Faults planted under the timed path, to show that ``correct`` catches
them (``perfbench/tests`` and ``calibrate.py --fault``). Each serving fault
is a context manager that patches the program while it is active; each
training fault wraps the training step."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def token():
    """A served token altered where it is produced: the first generated
    token of every decoded row moves to another id."""
    import whisperseg_torch.segmenter as segmenter

    real = segmenter.generate

    def altered(params, cfg, *args, **kwargs):
        out = real(params, cfg, *args, **kwargs).clone()
        out[:, 3] = (out[:, 3] + 7) % cfg.vocab_size
        return out

    segmenter.generate = altered
    try:
        yield
    finally:
        segmenter.generate = real


def _frame_patch(shift):
    """Patch the frame head's outputs where they are produced: ``shift``
    maps the batch's logits [B, S, 3] to what is served."""
    import torch
    import whisperseg_torch.segmenter as segmenter

    real = segmenter._frame_outputs

    def altered(*args, **kwargs):
        probs, cl = real(*args, **kwargs)
        p = probs.clamp(1e-6, 1 - 1e-6)
        return torch.sigmoid(shift(torch.log(p / (1 - p)))), cl

    segmenter._frame_outputs = altered
    return segmenter, real


@contextlib.contextmanager
def frame():
    """Every window's frame probabilities altered where they are produced:
    their logits moved by one, as a wrong bias in the head would move them."""
    segmenter, real = _frame_patch(lambda x: x + 1.0)
    try:
        yield
    finally:
        segmenter._frame_outputs = real


def _track(x):
    x = x.clone()
    x[..., 1] += 0.5
    return x


def _row(x):
    x = x.clone()
    x[-1] += 0.5
    return x


@contextlib.contextmanager
def frame_track():
    """One track wrong: the onset track's logits moved by a half, the vocal
    and offset tracks as served."""
    segmenter, real = _frame_patch(_track)
    try:
        yield
    finally:
        segmenter._frame_outputs = real


@contextlib.contextmanager
def frame_row():
    """One row of every batch wrong: the last row's logits moved by a
    half, the other rows as served."""
    segmenter, real = _frame_patch(_row)
    try:
        yield
    finally:
        segmenter._frame_outputs = real


@contextlib.contextmanager
def table():
    """The frame-VAD table altered where the host tail produces it: the
    last offset of every table moves 5 ms earlier."""
    import whisperseg_torch.segmenter as segmenter

    real = segmenter.segments_from_tracks

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        if out["offset"]:
            out = dict(out, offset=list(out["offset"][:-1])
                       + [round(out["offset"][-1] - 0.005, 3)])
        return out

    segmenter.segments_from_tracks = altered
    try:
        yield
    finally:
        segmenter.segments_from_tracks = real


def half_batch(step):
    """Half of each batch left out: the step sees its first rows only, so
    its mean is taken over them."""
    def broken(params, batch, gen):
        n = batch["labels"].shape[0] // 2
        cut = {k: (v[:n] if hasattr(v, "shape") else v)
               for k, v in batch.items()}
        return step(params, cut, gen)
    return broken


def frozen_state(step):
    """A step that returns its state unchanged (and a zero loss)."""
    import torch

    def broken(params, batch, gen):
        return torch.zeros(())
    return broken


def flipped_update(step):
    """Each step's update applied with its sign flipped: the parameters move
    as far as the step moves them, the other way."""
    import torch

    from .weights import flat

    def broken(params, batch, gen):
        before = {k: v.detach().clone() for k, v in flat(params).items()}
        loss = step(params, batch, gen)
        with torch.no_grad():
            for k, v in flat(params).items():
                v.mul_(-1).add_(before[k], alpha=2)
        return loss
    return broken


SERVING = {"token": token, "frame": frame, "frame_track": frame_track,
           "frame_row": frame_row, "table": table}
TRAINING = {"half_batch": half_batch, "frozen_state": frozen_state,
            "flipped_update": flipped_update}
