"""attn_roofline.segment: the least time of the encoder-attention kernel's
(K2, csrc/attention.cu) launches in the traced window, by the frozen bound
at their shapes, over their device time, in per cent."""

from perfbench import roofline
from perfbench.readers import device_ms, encoder_shape


def read(view):
    if view.trace is None:
        return None
    ks = [k for k in view.trace.matching("attention_hm")
          if "bwd" not in k[2]]
    if not ks:
        return None
    b, h, sp, hd, valid = encoder_shape(view)
    bound_ms, _ = roofline.attention_fwd_bound(b, h, h, sp, hd, valid)
    return 100.0 * len(ks) * bound_ms / device_ms(ks)
