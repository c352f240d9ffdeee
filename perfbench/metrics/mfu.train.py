"""mfu.train: three times the forward FLOPs of the traced training steps
over the traced window at 989 TFLOP/s, in per cent."""

from perfbench.readers import mfu as read  # noqa: F401
