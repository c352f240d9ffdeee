"""data_wait_ms_per_step.train: the program's ``train.data_wait`` spans (the
loader's wait on its queue for the next collated batch) in the traced window
summed, per ``train.step`` span there, in ms. The host-to-device copy
(``train.to_device``) is left out: while the copy is pageable it waits for
the previous step's device work, which is the model step's time and not the
loader's."""

from perfbench.spans import ms, records


def read(view):
    steps = records(view, "train.step")
    waits = records(view, "train.data_wait")
    if steps is None or waits is None:
        return None
    return sum(ms(r) for r in waits) / len(steps)
