"""What the per-layer readers (``perfbench/metrics/<metric>.py``) share.
Each reader is ``read(view) -> float or None``: ``view.trace`` is the
``DeviceTrace`` of the traced part of the window, ``view.work`` what the
driver counted there, ``view.model`` / ``view.mix`` the cell's files. A
reader that finds nothing to read returns None and the metric is left out."""

from __future__ import annotations

from typing import Optional

from . import roofline


def idle_share(view) -> Optional[float]:
    """Per cent of the traced window in which no device operation ran."""
    t = view.trace
    if t is None or t.window_ns <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns)


def mfu(view) -> Optional[float]:
    """The model FLOPs of the traced work over the traced window at the
    card's bf16 peak, in per cent."""
    t, flops = view.trace, (view.work or {}).get("model_flops")
    if t is None or not flops or t.window_ns <= 0:
        return None
    return 100.0 * flops / (t.window_ns / 1e9 * roofline.PEAK_FLOPS["bfloat16"])


def encoder_shape(view):
    """(batch, heads, padded positions, head size, valid positions) of the
    encoder's attention launches."""
    m = view.model
    s = m["total_spec_columns"] // 2
    heads = m["encoder_attention_heads"]
    return (view.work["encoder_batch"], heads, -(-s // 128) * 128,
            m["d_model"] // heads, s)


def device_ms(kernels) -> float:
    return sum(b - a for a, b, _ in kernels) / 1e6


def launches_per(view, unit: str) -> Optional[float]:
    t, n = view.trace, (view.work or {}).get(unit)
    if t is None or not n:
        return None
    return t.launches() / n
