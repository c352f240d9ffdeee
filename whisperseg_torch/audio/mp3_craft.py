"""Minimal MPEG-1 Layer III bitstream writer (mono, CBR, no reservoir).

The port's copy of ``whisperseg_tpu/audio/mp3_craft.py``;
it imports neither jax nor that package.

NOT an encoder: it emits frames whose side info and main data are given
explicitly, bit by bit. Two consumers:

* scripts/mp3_oracle_extract.py crafts probe streams, feeds them to the
  system libmpg123, and recovers the Layer III constant tables (synthesis
  window, Huffman codebooks, scalefactor band edges) from the decoded PCM —
  the behavioral-oracle derivation used because the tables are spec data
  that must match the authoritative decoder bit for bit.
* tests/test_mp3.py crafts known-spectrum streams as decoder fixtures.

Reference geometry (ISO 11172-3 2.4.1.7): MPEG-1 Layer III mono frame =
4-byte header + 17-byte side info + main data; frame length
144 * bitrate / sr (+1 padding byte, unused here).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

_V1_L3_BITRATES = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
                   224, 256, 320, 0)
_V1_SRS = (44100, 48000, 32000)


class BitWriter:
    def __init__(self):
        self._bits: List[int] = []

    def write(self, value: int, nbits: int) -> "BitWriter":
        for i in range(nbits - 1, -1, -1):
            self._bits.append((value >> i) & 1)
        return self

    def write_bits(self, bitstring: str) -> "BitWriter":
        for c in bitstring:
            self._bits.append(1 if c == "1" else 0)
        return self

    def __len__(self) -> int:
        return len(self._bits)

    def to_bytes(self, pad_to: Optional[int] = None) -> bytes:
        bits = list(self._bits)
        while len(bits) % 8:
            bits.append(0)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i: i + 8]:
                b = (b << 1) | bit
            out.append(b)
        if pad_to is not None:
            if len(out) > pad_to:
                raise ValueError(f"payload {len(out)} exceeds {pad_to} bytes")
            out.extend(b"\x00" * (pad_to - len(out)))
        return bytes(out)


@dataclass
class Granule:
    """Side-info fields for one mono granule + its main-data bits."""

    main_bits: str = ""            # scalefactor + huffman bits, MSB first
    big_values: int = 0
    global_gain: int = 210
    scalefac_compress: int = 0
    block_type: int = 0            # 0 long; 1/3 start/stop; 2 short
    mixed_block: bool = False
    table_select: tuple = (0, 0, 0)
    subblock_gain: tuple = (0, 0, 0)
    region0_count: int = 0
    region1_count: int = 0
    preflag: int = 0
    scalefac_scale: int = 0
    count1table_select: int = 1    # 1 = table B (the fixed-length table)
    part2_3_length: Optional[int] = None  # default: len(main_bits)


def frame_bytes(sr: int = 32000, bitrate_kbps: int = 320) -> int:
    return 144 * bitrate_kbps * 1000 // sr


def craft_mono_frame(granules: List[Granule], sr: int = 32000,
                     bitrate_kbps: int = 320) -> bytes:
    """Two granules -> one MPEG-1 Layer III mono frame (no CRC, no padding)."""
    assert len(granules) == 2
    sr_idx = _V1_SRS.index(sr)
    br_idx = _V1_L3_BITRATES.index(bitrate_kbps)
    h = BitWriter()
    h.write(0x7FF, 11)      # sync
    h.write(0b11, 2)        # MPEG-1
    h.write(0b01, 2)        # Layer III
    h.write(1, 1)           # protection: no CRC
    h.write(br_idx, 4)
    h.write(sr_idx, 2)
    h.write(0, 1)           # padding
    h.write(0, 1)           # private
    h.write(0b11, 2)        # mono
    h.write(0, 2)           # mode extension
    h.write(0, 1)           # copyright
    h.write(0, 1)           # original
    h.write(0, 2)           # emphasis

    side = BitWriter()
    side.write(0, 9)        # main_data_begin = 0 (no reservoir)
    side.write(0, 5)        # private bits (mono)
    side.write(0, 4)        # scfsi
    for g in granules:
        p23 = g.part2_3_length if g.part2_3_length is not None \
            else len(g.main_bits)
        side.write(p23, 12)
        side.write(g.big_values, 9)
        side.write(g.global_gain, 8)
        side.write(g.scalefac_compress, 4)
        if g.block_type == 0:
            side.write(0, 1)                    # window_switching off
            for t in g.table_select:
                side.write(t, 5)
            side.write(g.region0_count, 4)
            side.write(g.region1_count, 3)
        else:
            side.write(1, 1)                    # window_switching on
            side.write(g.block_type, 2)
            side.write(1 if g.mixed_block else 0, 1)
            for t in g.table_select[:2]:
                side.write(t, 5)
            for sg in g.subblock_gain:
                side.write(sg, 3)
        side.write(g.preflag, 1)
        side.write(g.scalefac_scale, 1)
        side.write(g.count1table_select, 1)

    main = BitWriter()
    for g in granules:
        main.write_bits(g.main_bits)

    total = frame_bytes(sr, bitrate_kbps)
    body = side.to_bytes() + main.to_bytes(pad_to=total - 4 - 17)
    return h.to_bytes() + body


def craft_stream(granules: List[Granule], sr: int = 32000,
                 bitrate_kbps: int = 320) -> bytes:
    """Pack granules two-per-frame (zero-granule-padded) into a stream."""
    gs = list(granules)
    if len(gs) % 2:
        gs.append(Granule())
    out = b""
    for i in range(0, len(gs), 2):
        out += craft_mono_frame(gs[i: i + 2], sr, bitrate_kbps)
    return out
