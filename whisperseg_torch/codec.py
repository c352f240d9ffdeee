"""Token-sequence -> segment list (a copy of ``whisperseg_tpu/codec.py``'s
parser; host-side Python over the ids the decoder produced)."""

from __future__ import annotations

from typing import Dict, List, Sequence

from . import tokenizer as tok
from .constants import RATIO_DECODING_TIME_STEP_TO_SPEC_TIME_STEP as RATIO


def col_to_time(col: int, spec_time_step: float) -> float:
    return col * spec_time_step * RATIO


def parse_segments_from_ids(
    ids: Sequence[int],
    spec_time_step: float,
    inverse_cluster_codebook: Dict[int, str],
    extra_tokens: Sequence[str] = (),
) -> List[List]:
    """Scan a generated token sequence for (onset_ts, digits+, offset_ts)
    triples. After a match the scan resumes after the closing timestamp, so a
    closing timestamp never opens the next segment. Unknown cluster ids and
    non-positive-length segments are dropped.

    Returns a list of mutable ``[onset_seconds, offset_seconds, cluster_name]``.
    """
    def digit_surface(t: int) -> str:
        if tok.is_digit(t):
            return str(t - tok.DIGIT_BASE)
        return tok.extended_digits(t, extra_tokens)

    out: List[List] = []
    i = 0
    n = len(ids)
    while i < n:
        if not tok.is_timestamp(int(ids[i])):
            i += 1
            continue
        j = i + 1
        digits = ""
        while j < n and digit_surface(int(ids[j])):
            digits += digit_surface(int(ids[j]))
            j += 1
        if digits and j < n and tok.is_timestamp(int(ids[j])):
            onset = col_to_time(int(ids[i]) - tok.TIMESTAMP_BASE, spec_time_step)
            offset = col_to_time(int(ids[j]) - tok.TIMESTAMP_BASE, spec_time_step)
            cluster_id = int(digits)
            if cluster_id in inverse_cluster_codebook and offset - onset > 0:
                out.append([onset, offset, inverse_cluster_codebook[cluster_id]])
            i = j + 1
        else:
            i += 1
    return out
