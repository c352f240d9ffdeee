"""launches_per_window.segment: device kernels (copies and fills left out)
launched in the traced window, per window of audio completed there."""

from perfbench.readers import launches_per


def read(view):
    return launches_per(view, "windows")
