"""The compact 1024-token segmentation vocabulary (the part decoding needs).

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

from typing import Sequence

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


def is_timestamp(token_id: int) -> bool:
    return TIMESTAMP_BASE <= token_id < TIMESTAMP_BASE + NUM_TIMESTAMPS


def is_digit(token_id: int) -> bool:
    return 0 <= token_id < 10


def extended_digits(token_id: int, extra_tokens: Sequence[str]) -> str:
    """Digit surface of an extended token id (ids >= VOCAB_SIZE, multi-digit
    cluster pieces of an imported checkpoint), or '' if it is not one."""
    k = token_id - VOCAB_SIZE
    if 0 <= k < len(extra_tokens) and extra_tokens[k].isdigit():
        return extra_tokens[k]
    return ""
