"""Readings that the limits in ``perfbench/limits`` are set from: the
numbers a cell compares, for the program on many seeds, for the control
and for planted faults, each on the card at the cell's own size.

    python3 perfbench/calibrate.py --workload CELL --seeds 12 --seconds 5 \
        [--controls 3] [--fault NAME:3 ...] [--out FILE]

The control is the nearest precision below the configuration's bf16. Where
the mix names a lower-precision path of the program's own (``control``:
the segment mix's int8 weights and int8 K/V), the program runs with it in
its place (``--controls`` seeds); elsewhere it is the reference with
float8 (e4m3) products, run over the same windows or training items as the
program's reading (the ``control_*`` numbers of every program run).

One JSON line a run: the device it ran on (torch's name for it, and
``nvidia-smi``'s name and power limit), which side, its seed, and every
number its check read. Like ``run.py`` it exits with an error and reads
nothing where there is no CUDA device: the limits are set from readings on
the card only. The seeds are large and differ from run to run only by
their index."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import common, faults, run  # noqa: E402

# every program run reads the float8 control beside it
PROGRAM = {"control": True}


def one(cell, seed: int, seconds: float, device, options, patch=None):
    args = run.parse(["--workload", cell.name, "--seed", str(seed),
                      "--seconds", str(seconds)])
    with patch() if patch else contextlib.nullcontext():
        result, _compared, out = run.execute(args, cell, device, options)
    one.last = {"e2e": out["e2e"], "host": out["host"], "memory_peak_bytes":
                result["device"]["memory_peak_bytes"],
                "attempted": result["attempted"]}
    return out["check"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--base_seed", type=int, default=4_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        common.fail("no CUDA device: limits are calibrated on the card only")
    device = torch.device("cuda", 0)
    card = {"device": torch.cuda.get_device_name(device),
            "card": common.card_name()}
    cell = common.load_cell(args.workload)
    plan = [("program", args.base_seed + i, PROGRAM, None)
            for i in range(args.seeds)]
    if "control" in cell.mix:
        plan += [("control", args.base_seed + 100 + i,
                  {"program_control": cell.mix["control"]}, None)
                 for i in range(args.controls)]
    for spec in args.fault:
        name, _, count = spec.partition(":")
        for i in range(int(count or 3)):
            seed = args.base_seed + 200 + i
            if name in faults.TRAINING:
                plan.append((name, seed, {"step_wrapper": faults.TRAINING[name]},
                             None))
            else:
                plan.append((name, seed, {}, faults.SERVING[name]))
    out = open(args.out, "a") if args.out else None
    for side, seed, options, patch in plan:
        t0 = time.time()
        numbers = one(cell, seed, args.seconds, device, options, patch)
        line = json.dumps({**card, "cell": cell.name, "side": side,
                           "seed": seed, "numbers": numbers, **one.last,
                           "seconds": round(time.time() - t0, 1)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()


if __name__ == "__main__":
    main()
