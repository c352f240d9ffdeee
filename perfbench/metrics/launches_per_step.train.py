"""launches_per_step.train: device kernels (copies and fills left out)
launched in the traced window, per training step completed there."""

from perfbench.readers import launches_per


def read(view):
    return launches_per(view, "steps")
