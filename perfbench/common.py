"""What every cell shares: finding a cell's files by name, the program's
configuration object, the card's description, and the result line."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "whisperseg_tpu")


@dataclass
class Cell:
    """One entry of ``workloads`` with everything found by its names."""
    name: str
    entry: dict                 # the BENCHMARK.json entry
    model: dict                 # perfbench/configs/<config>.json
    mix: dict                   # perfbench/traffic/<traffic>.json
    limits: dict                # perfbench/limits/<workload>.json
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its configuration,
    mix and limits, and the metrics it reports."""
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, "perfbench")
    mix = _read(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    limits = _read(os.path.join(here, "limits", name + ".json"))

    def mine(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in names]
    return Cell(name, entry, _read(os.path.join(root, conf["file"])), mix,
                limits, e2e, layer)


def program_config(model: dict, **extra):
    """The program's ``WhisperConfig`` for a configuration file."""
    from whisperseg_torch.models.config import WhisperConfig

    return WhisperConfig(
        d_model=model["d_model"], encoder_layers=model["encoder_layers"],
        decoder_layers=model["decoder_layers"],
        num_heads=model["encoder_attention_heads"],
        d_ff=model["encoder_ffn_dim"], num_mel_bins=model["num_mel_bins"],
        vocab_size=model["vocab_size"],
        max_source_positions=model["max_source_positions"],
        max_target_positions=model["max_target_positions"],
        total_spec_columns=model["total_spec_columns"],
        compute_dtype=model["compute_dtype"], dropout=0.0,
        frame_head=bool(model.get("frame_head_clusters") is not None),
        frame_head_clusters=int(model.get("frame_head_clusters") or 0),
        model_name=model["name"], **extra)


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def fail(message: str, code: int = 2) -> None:
    print(message, file=sys.stderr, flush=True)
    raise SystemExit(code)


def compared_lines(compared: Dict[str, dict]) -> str:
    return "\n".join(f"compared {k}: {v['value']!r} limit {v['limit']!r}"
                     for k, v in compared.items())


def judge(numbers: Dict[str, Optional[float]], limits: dict) -> Dict[str, dict]:
    """Each number beside its limit; a number that could not be read is
    ``None`` and fails."""
    return {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}


def passed(compared: Dict[str, dict]) -> bool:
    return all(v["value"] is not None and v["value"] <= v["limit"]
               for v in compared.values())
