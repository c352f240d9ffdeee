"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix, its limits and its per-layer
readers are found by name from BENCHMARK.json (``perfbench/configs``,
``perfbench/traffic``, ``perfbench/limits``, ``perfbench/metrics``); the
mix's ``entry`` names its driver in ``perfbench/entries``. The driver loads,
warms up, measures for ``--seconds``, and checks what the timed path
produced against the plain reference. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number the check compared beside its limit); the last lines of standard
error repeat the compared numbers. With ``--trace 0`` the metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a library that the port uses must not load JAX for it
os.environ.setdefault("USE_FLAX", "0")

from perfbench import common  # noqa: E402


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device and
    the process's start on the host clock."""
    cell: common.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    options: dict = field(default_factory=dict)
    host: dict = field(default_factory=dict)    # the host in the window

    def tracer(self):
        """A started device trace in a traced run, else None."""
        if not self.trace:
            return None
        from perfbench.trace import DeviceTrace
        return DeviceTrace().start()


@dataclass
class View:
    trace: object
    work: dict
    model: dict
    mix: dict


def read_metric(name: str, view: View):
    path = os.path.join(common.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(view)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, cell: common.Cell, device, options=None):
    """Drive the cell on ``device``: (its result line, the compared numbers
    beside their limits as read, the driver's output)."""
    ctx = Context(cell, int(args.seed), float(args.seconds), bool(args.trace),
                  device, T_START, dict(options or {}))
    if ctx.seed < 0:
        common.fail("--seed must be a non-negative integer")
    entry = importlib.import_module(f"perfbench.entries.{cell.mix['entry']}")
    out = entry.run(ctx)
    out["host"] = ctx.host
    compared = common.judge(out["check"], cell.limits)
    result = {"correct": common.passed(compared),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _kind(device), "count": 1,
           "memory_peak_bytes": int(out["memory_peak"])}
    if ctx.trace:
        t = out["trace"]
        view = View(t, out.get("work") or {}, cell.model, cell.mix)
        for m in cell.per_layer:
            value = read_metric(m["name"], view)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        dev["busy_s"] = t.busy_ns() / 1e9
        dev["window_s"] = t.window_ns / 1e9
        result["breakdown"] = t.breakdown()
    else:
        for m in cell.end_to_end:
            value = out["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    result["metrics"] = metrics
    result["device"] = dev
    result["compared"] = {k: {"value": _finite(v["value"]),
                              "limit": v["limit"]}
                          for k, v in compared.items()}
    return result, compared, out


def _kind(device) -> str:
    if device.type != "cuda":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(device)


def emit(result: dict, raw: dict, out: dict) -> None:
    """The compared numbers as the last lines of standard error, the result
    as the last line of standard output."""
    print("card: " + common.card_name(), file=sys.stderr)
    print("end to end: " + ", ".join(f"{k} {v!r}" for k, v in
                                     out["e2e"].items()), file=sys.stderr)
    print(f"requests or steps: {out['attempted']}, window "
          f"{out['window_s']!r} s", file=sys.stderr)
    print("host in the window: " + ", ".join(
        f"{k} {v!r}" for k, v in out.get("host", {}).items()),
        file=sys.stderr)
    print(common.compared_lines(raw), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> None:
    args = parse(argv)
    cell = common.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        common.fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < int(cell.entry["chips"]):
        common.fail(f"{cell.name} needs {cell.entry['chips']} cards, "
                    f"{torch.cuda.device_count()} found")
    result, raw, out = execute(args, cell, torch.device("cuda", 0))
    found = common.forbidden_modules()
    if found:
        common.fail("loaded in this process: " + ", ".join(found))
    emit(result, raw, out)


if __name__ == "__main__":
    main()
