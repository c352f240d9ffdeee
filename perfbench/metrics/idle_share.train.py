"""idle_share.train: per cent of the traced window with no device
operation running (the union of kernel intervals, as chip_smoke.py's
report_profile takes it), in the fine-tuning cell."""

from perfbench.readers import idle_share as read  # noqa: F401
