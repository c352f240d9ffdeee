"""mfu.segment: the model FLOPs that the traced recordings needed (each
window's encoder, its decoded positions on every beam row, the frame head)
over the traced window at 989 TFLOP/s, in per cent."""

from perfbench.readers import mfu as read  # noqa: F401
