"""attn_bwd_roofline.train: the least time of the encoder-attention
backward kernels' (K6 dK/dV and dQ, csrc/attention_bwd.cu) launches in the
traced steps, by the frozen bounds at their shapes, over their device time,
in per cent."""

from perfbench import roofline
from perfbench.readers import device_ms, encoder_shape


def read(view):
    if view.trace is None:
        return None
    dkv = view.trace.matching("attention_bwd_dkv")
    dq = view.trace.matching("attention_bwd_dq")
    if not dkv or not dq:
        return None
    b, h, sp, hd, valid = encoder_shape(view)
    (b_dkv, _), (b_dq, _) = roofline.attention_bwd_bounds(b, h, h, sp, hd, valid)
    return 100.0 * (len(dkv) * b_dkv + len(dq) * b_dq) / (
        device_ms(dkv) + device_ms(dq))
