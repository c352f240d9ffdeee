"""The yardstick's arithmetic: the H100's published peaks, the least time a
launch needs (``bound``), the bytes and operations of the encoder-attention
kernels, and the model FLOPs that a piece of completed work needs.

``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``bound`` and the attention counts are
frozen copies of ``chip_smoke.py``'s (``bound``, ``check_attention``,
``check_attention_backward``), with the dtype given by name so that no card
is needed to evaluate them. Model FLOPs count each multiply-add as two
operations, from the configuration's shapes alone, whatever implements the
model."""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s by operand type (bf16 on the tensor cores, float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ITEM = {"bfloat16": 2, "float32": 4}


def bound(nbytes: float, flops: float, dtype: str):
    """Least time in ms for ``nbytes`` of device memory traffic and ``flops``
    operations of ``dtype``, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def attention_fwd_bound(b, h, hkv, sp, hd, valid, dtype="bfloat16",
                        with_lse=False):
    """K2 (``csrc/attention.cu``) on q [b, h, sp, hd], K^T [b, hkv, hd, sp],
    V [b, hkv, sp, hd]: each input read once, the output (and with the
    training forward, the float32 row log-sum-exp) written once; 4 operations
    a (query, valid key, channel)."""
    item = ITEM[dtype]
    q = b * h * sp * hd
    kv = b * hkv * sp * hd
    nbytes = item * (2 * q + 2 * kv) + (4 * b * h * sp if with_lse else 0)
    return bound(nbytes, 4 * b * h * sp * valid * hd, dtype)


def attention_bwd_bounds(b, h, hkv, sp, hd, valid, dtype="bfloat16"):
    """(dK/dV bound, dQ bound) of K6's two backward kernels
    (``csrc/attention_bwd.cu``): q, K^T, V, dO read once with the float32
    log-sum-exp and D rows, the gradients written once; 4 and 3 products of
    2 operations a (query, valid key, channel)."""
    item = ITEM[dtype]
    q = b * h * sp * hd
    kv = b * hkv * sp * hd
    products = 2 * b * h * sp * valid * hd
    ins = item * (2 * q + 2 * kv) + 8 * b * h * sp
    return (bound(ins + item * 2 * kv, 4 * products, dtype),
            bound(ins + item * q, 3 * products, dtype))


# ------------------------------------------------------------- model FLOPs


def encoder_flops(m: dict, columns: int) -> float:
    """One window: two convolutions over ``columns`` spectrogram columns,
    then the layers at S = columns // 2 positions."""
    d, f, s = m["d_model"], m["encoder_ffn_dim"], columns // 2
    macs = columns * 3 * m["num_mel_bins"] * d + s * 3 * d * d
    macs += m["encoder_layers"] * (4 * s * d * d + 2 * s * s * d + 2 * s * d * f)
    return 2.0 * macs


def cross_kv_flops(m: dict, columns: int) -> float:
    """The decoder's cross-attention keys and values of one window."""
    d = m["d_model"]
    return 2.0 * m["decoder_layers"] * 2 * (columns // 2) * d * d


def decoder_token_flops(m: dict, position: int, columns: int) -> float:
    """One token through the cached decoder at ``position`` (attending to
    ``position + 1`` cached keys and the window's S encoder states), with
    its logits."""
    d, f, s = m["d_model"], m["decoder_ffn_dim"], columns // 2
    per_layer = 4 * d * d + 2 * (position + 1) * d + 2 * d * d + 2 * s * d \
        + 2 * d * f
    return 2.0 * (m["decoder_layers"] * per_layer + d * m["vocab_size"])


def frame_head_flops(m: dict, columns: int) -> float:
    d = m["d_model"]
    hidden = max(d // 2, 64)
    return 2.0 * (columns // 2) * (d * hidden + hidden * (3 + m.get(
        "frame_head_clusters", 0)))


def decoded_window_flops(m: dict, columns: int, fed: int, rows: int) -> float:
    """A window decoded by ``rows`` hypotheses (beams) that each fed
    ``fed`` tokens (the prompt and every generated token but the last):
    cross keys and values once, then each fed position on every row."""
    tokens = sum(decoder_token_flops(m, p, columns) for p in range(fed))
    return cross_kv_flops(m, columns) + rows * tokens


def train_step_flops(m: dict, columns: int, batch: int, length: int) -> float:
    """Forward and backward (3x the forward) of one teacher-forced step:
    ``batch`` windows through the encoder and ``length`` target positions
    through the decoder with causal self-attention."""
    d, f, s = m["d_model"], m["decoder_ffn_dim"], columns // 2
    dec = m["decoder_layers"] * (
        length * (4 * d * d + 2 * d * d + 2 * d * f + 2 * s * d)
        + length * (length + 1) * d + 2 * s * d * d)
    dec += length * d * m["vocab_size"]
    forward = encoder_flops(m, columns) + 2.0 * dec
    return 3.0 * batch * forward
