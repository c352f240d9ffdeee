"""Segments <-> decoder tokens (a copy of ``whisperseg_tpu/codec.py``):
training targets from labelled segments, and the parser of the ids the
decoder produced. Host-side Python."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import tokenizer as tok
from .constants import RATIO_DECODING_TIME_STEP_TO_SPEC_TIME_STEP as RATIO


def time_to_col(t: float, spec_time_step: float, total_spec_columns: int) -> int:
    """A time in seconds -> its decoder timestamp column (numpy's
    round-half-to-even), clipped to ``total_spec_columns``."""
    return min(int(np.round(t / (spec_time_step * RATIO))), total_spec_columns)


def col_to_time(col: int, spec_time_step: float) -> float:
    return col * spec_time_step * RATIO


def cluster_digits(cluster_id: int) -> List[int]:
    """Cluster integer id -> digit token ids ('12' -> [1, 2])."""
    if cluster_id < 0:
        raise ValueError("cluster ids must be non-negative")
    return [tok.DIGIT_BASE + (ord(c) - ord("0")) for c in str(cluster_id)]


def build_target_ids(
    species: str,
    onsets: Sequence[float],
    offsets: Sequence[float],
    cluster_ids: Sequence[int],
    spec_time_step: float,
    total_spec_columns: int,
    extra_token_ids: Dict[str, int] = None,
    cluster_encodings: Dict[str, list] = None,
) -> List[int]:
    """One training clip's full decoder sequence: prompt, species, then
    (onset timestamp, cluster digits, offset timestamp) per segment, then
    EOT. ``extra_token_ids`` (piece -> extended id) encodes cluster ids as a
    checkpoint with multi-digit pieces generates them."""
    ids: List[int] = list(tok.PROMPT_IDS)
    ids.append(tok.species_token(species))
    for onset, offset, cid in zip(onsets, offsets, cluster_ids):
        ids.append(tok.timestamp_id(time_to_col(onset, spec_time_step,
                                                total_spec_columns)))
        if extra_token_ids:
            ids.extend(tok.encode_cluster_string(str(int(cid)), extra_token_ids,
                                                 cluster_encodings))
        else:
            ids.extend(cluster_digits(int(cid)))
        ids.append(tok.timestamp_id(time_to_col(offset, spec_time_step,
                                                total_spec_columns)))
    ids.append(tok.EOT_ID)
    return ids


def shift_for_training(ids: Sequence[int], max_length: int,
                       ignore_id: int = -100) -> Tuple[List[int], List[int]]:
    """A full decoder sequence cut to ``max_length + 1`` -> (decoder input
    ids = seq[:-1] padded with PAD, labels = seq[1:] padded with
    ``ignore_id``), each ``max_length`` long."""
    seq = list(ids)[: max_length + 1]
    inputs, labels = seq[:-1], seq[1:]
    inputs = inputs + [tok.PAD_ID] * (max_length - len(inputs))
    labels = labels + [ignore_id] * (max_length - len(labels))
    return inputs, labels


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


def parse_segments_from_text(
    text: str,
    spec_time_step: float,
    inverse_cluster_codebook: Dict[int, str],
) -> List[List]:
    """:func:`parse_segments_from_ids` over ``tokenizer.encode_text(text)``."""
    return parse_segments_from_ids(
        tok.encode_text(text), spec_time_step, inverse_cluster_codebook)
