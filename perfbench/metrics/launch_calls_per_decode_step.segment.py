"""launch_calls_per_decode_step.segment: the host's launch calls
(``cudaLaunchKernel``, ``cuLaunchKernelEx`` and every other call with
``LaunchKernel`` in its name, and graph launches, one each) that start
inside the program's ``decode.step`` spans in the traced window, per
step."""

from perfbench.spans import launch_calls_inside, records


def read(view):
    steps = records(view, "decode.step")
    if steps is None:
        return None
    return launch_calls_inside(view, steps) / len(steps)
