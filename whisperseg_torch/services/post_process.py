"""Per-model prediction post-processing hooks.

The port's copy of ``whisperseg_tpu/services/post_process.py``;
it imports neither jax nor that package.

Port of the reference's PROCESS_TOOLBOX mechanism (reference
scripts/post_process_predictions.py): a registry mapping model names to functions
that rewrite the prediction table. The one shipped rule set is the marmoset
cleanup for ``whisperseg-large-marmoset-v2.0``: runs of more than five consecutive
``e_ts`` twitter-syllable calls (tolerating single sub-10 ms interruptions) are
merged into one ``e_tw`` twitter-phrase segment, and up to three trailing ``e_p*``
calls that closely follow an ``e_tw`` are absorbed into it (the first two extend
its offset).

Operates on ``{"onset": [...], "offset": [...], "cluster": [...]}`` dictionaries
(the reference routes through pandas DataFrames; the semantics are the same).
"""

from __future__ import annotations

from typing import Callable, Dict, List


def _rows(prediction: dict) -> List[dict]:
    return [
        {"onset": o, "offset": f, "cluster": c}
        for o, f, c in zip(prediction["onset"], prediction["offset"],
                           prediction["cluster"])
    ]


def _table(rows: List[dict]) -> dict:
    rows = sorted(rows, key=lambda r: r["onset"])
    return {
        "onset": [r["onset"] for r in rows],
        "offset": [r["offset"] for r in rows],
        "cluster": [r["cluster"] for r in rows],
    }


def detect_continuous_e_ts(rows: List[dict]) -> List[List[int]]:
    """Index ranges [start, end) of qualifying e_ts runs (reference
    post_process_predictions.py:8-32)."""
    runs: List[List[int]] = []
    for idx, row in enumerate(rows):
        if row["cluster"] == "e_ts":
            if not runs or len(runs[-1]) == 2:
                runs.append([idx])
            else:
                if idx > 0 and row["onset"] - rows[idx - 1]["offset"] > 0.01:
                    # gap too large: close the current run (dropping it if short)
                    if idx - runs[-1][0] <= 5:
                        runs.pop()
                    else:
                        runs[-1].append(idx)
                    runs.append([idx])
        else:
            if (0 < idx < len(rows) - 1
                    and rows[idx - 1]["cluster"] == "e_ts"
                    and rows[idx + 1]["cluster"] == "e_ts"):
                # an interruption sandwiched between e_ts never closes the run
                # (in the reference both branches of its inner gap check fall
                # through; post_process_predictions.py:22-24)
                continue
            if runs and len(runs[-1]) == 1:
                if idx - runs[-1][0] <= 5:
                    runs.pop()
                else:
                    runs[-1].append(idx)
    if runs and len(runs[-1]) == 1:
        runs.pop()
    return runs


def convert_continuous_e_ts_to_e_tw(rows: List[dict]) -> List[dict]:
    """(reference post_process_predictions.py:34-54)"""
    runs = detect_continuous_e_ts(rows)
    skip = set()
    for start, end in runs:
        skip.update(range(start, end))
    out = [r for i, r in enumerate(rows) if i not in skip]
    for start, end in runs:
        if not rows[end - 1]["offset"] > rows[start]["onset"]:
            continue
        out.append({"onset": rows[start]["onset"],
                    "offset": rows[end - 1]["offset"],
                    "cluster": "e_tw"})
    return sorted(out, key=lambda r: r["onset"])


def clean_e_tw_follows(rows: List[dict]) -> List[dict]:
    """(reference post_process_predictions.py:56-81)

    NOTE: ``is_checking`` starts at 3 BEFORE any e_tw is seen, so up to three
    adjacent leading segments can be removed with no preceding twitter phrase.
    That is the reference's exact behavior (its line 58) and this port is
    oracle-tested against it — kept bug-compatible on purpose."""
    remove = set()
    is_checking = 3
    current_tw = None
    for idx, row in enumerate(rows):
        if row["cluster"] == "e_tw":
            is_checking = 3
            current_tw = idx
        elif is_checking > 0:
            close_ep = (row["cluster"].startswith("e_p") and idx > 0
                        and row["onset"] - rows[idx - 1]["offset"] < 0.1)
            adjacent = idx > 0 and row["onset"] - rows[idx - 1]["offset"] < 0.01
            if close_ep or adjacent:
                remove.add(idx)
                if is_checking > 1 and current_tw is not None:
                    rows[current_tw]["offset"] = row["offset"]
                is_checking -= 1
            else:
                is_checking = 0
    return sorted((r for i, r in enumerate(rows) if i not in remove),
                  key=lambda r: r["onset"])


def post_process_marmoset(prediction: dict) -> dict:
    try:
        rows = clean_e_tw_follows(convert_continuous_e_ts_to_e_tw(_rows(prediction)))
        return _table(rows)
    except Exception:
        return prediction


PROCESS_TOOLBOX: Dict[str, Callable[[dict], dict]] = {
    "whisperseg-large-marmoset-v2.0": post_process_marmoset,
}
