"""The compact 1024-token segmentation vocabulary: its id layout, the
token strings (``ID_TO_TOKEN``) and the text encoder and decoder.

A copy of the id layout of ``whisperseg_tpu/tokenizer.py``:

    0..9      digits '0'..'9'
    10        <|pad|>
    11        <|endoftext|>
    12        <|startoftranscript|>
    13        <|en|>
    14        <|notimestamps|>
    15..21    species tokens <|zebra_finch|> .. <|animal|>
    22        <|reserved0|>
    23..1023  timestamp tokens <|0|> .. <|1000|>
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

DIGIT_BASE = 0
PAD_ID = 10
EOT_ID = 11
SOT_ID = 12
EN_ID = 13
NOTIMESTAMPS_ID = 14
SPECIES_BASE = 15
RESERVED_ID = 22
TIMESTAMP_BASE = 23
NUM_TIMESTAMPS = 1001  # <|0|> .. <|1000|> inclusive
VOCAB_SIZE = TIMESTAMP_BASE + NUM_TIMESTAMPS  # == 1024

# Decoder prompt used for both training and generation.
PROMPT_IDS = (SOT_ID, EN_ID, NOTIMESTAMPS_ID)

SPECIES_LIST = ("zebra_finch", "bengalese_finch", "mouse", "marmoset",
                "human", "unknown", "animal")
SPECIES_TOKEN_IDS: Dict[str, int] = {
    name: SPECIES_BASE + i for i, name in enumerate(SPECIES_LIST)}

_SPECIAL_RE = re.compile(r"<\|([^|]*)\|>")


def _build_id_to_token() -> List[str]:
    toks = [str(d) for d in range(10)]
    toks += ["<|pad|>", "<|endoftext|>", "<|startoftranscript|>", "<|en|>",
             "<|notimestamps|>"]
    toks += [f"<|{name}|>" for name in SPECIES_LIST]
    toks += ["<|reserved0|>"]
    toks += [f"<|{i}|>" for i in range(NUM_TIMESTAMPS)]
    assert len(toks) == VOCAB_SIZE
    return toks


ID_TO_TOKEN: List[str] = _build_id_to_token()
TOKEN_TO_ID: Dict[str, int] = {t: i for i, t in enumerate(ID_TO_TOKEN)}


def timestamp_id(col: int) -> int:
    """Token id of the timestamp token <|col|>."""
    if not 0 <= col < NUM_TIMESTAMPS:
        raise ValueError(f"timestamp column {col} out of range [0, {NUM_TIMESTAMPS})")
    return TIMESTAMP_BASE + col


def species_token(species: str) -> int:
    """Species name -> token id; unknown species map to <|unknown|>."""
    return SPECIES_TOKEN_IDS.get(species, SPECIES_TOKEN_IDS["unknown"])


def encode_cluster_string(digits: str, extra_token_ids: Dict[str, int],
                          cluster_encodings: Dict[str, list] = None
                          ) -> List[int]:
    """A cluster-id digit string -> token ids: the checkpoint's recorded
    piece sequence where ``cluster_encodings`` covers it, else greedy
    longest match over the extended pieces, falling back to one token per
    digit (the compact vocabulary's own encoding)."""
    def digit(c: str) -> int:
        return DIGIT_BASE + (ord(c) - ord("0"))

    if cluster_encodings and digits in cluster_encodings:
        ids: List[int] = []
        for piece in cluster_encodings[digits]:
            if len(piece) == 1:
                ids.append(digit(piece))
            elif piece in extra_token_ids:
                ids.append(extra_token_ids[piece])
            else:  # a recorded piece without its extended row: per digit
                ids.extend(digit(c) for c in piece)
        return ids
    ids = []
    i, n = 0, len(digits)
    while i < n:
        match = next(((extra_token_ids[digits[i:j]], j) for j in range(n, i + 1, -1)
                      if digits[i:j] in extra_token_ids), None)
        if match is None:
            ids.append(digit(digits[i]))
            i += 1
        else:
            ids.append(match[0])
            i = match[1]
    return ids


def is_timestamp(token_id: int) -> bool:
    return TIMESTAMP_BASE <= token_id < TIMESTAMP_BASE + NUM_TIMESTAMPS


def is_digit(token_id: int) -> bool:
    return 0 <= token_id < 10


def encode_text(text: str) -> List[int]:
    """A label or generated text -> ids (no prompt, no EOT added): a
    concatenation of ``<|special|>`` markers and decimal digit runs, one id
    per digit; whitespace is skipped, anything else raises."""
    ids: List[int] = []

    def digits(run: str):
        for ch in run:
            if ch.isdigit():
                ids.append(ord(ch) - ord("0"))
            elif not ch.isspace():
                raise ValueError(f"cannot tokenize character {ch!r} in {text!r}")

    pos = 0
    for m in _SPECIAL_RE.finditer(text):
        digits(text[pos:m.start()])
        if m.group(0) not in TOKEN_TO_ID:
            raise ValueError(f"unknown special token {m.group(0)!r}")
        ids.append(TOKEN_TO_ID[m.group(0)])
        pos = m.end()
    digits(text[pos:])
    return ids


def decode_ids(ids: Sequence[int], skip_special_tokens: bool = False,
               extra_tokens: Sequence[str] = ()) -> str:
    """Ids -> text. ``extra_tokens`` are the surfaces of the extended ids
    (>= VOCAB_SIZE, the multi-digit cluster pieces of an imported HF
    checkpoint, models/convert_hf.py); other ids out of range are dropped."""
    parts = []
    for i in ids:
        i = int(i)
        if 0 <= i < VOCAB_SIZE:
            token = ID_TO_TOKEN[i]
        elif VOCAB_SIZE <= i < VOCAB_SIZE + len(extra_tokens):
            token = extra_tokens[i - VOCAB_SIZE]
        else:
            continue
        if skip_special_tokens and token.startswith("<|"):
            continue
        parts.append(token)
    return "".join(parts)


def extended_digits(token_id: int, extra_tokens: Sequence[str]) -> str:
    """Digit surface of an extended token id (ids >= VOCAB_SIZE, multi-digit
    cluster pieces of an imported checkpoint), or '' if it is not one."""
    k = token_id - VOCAB_SIZE
    if 0 <= k < len(extra_tokens) and extra_tokens[k].isdigit():
        return extra_tokens[k]
    return ""
