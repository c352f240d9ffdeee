"""From-scratch FLAC codec (pure Python + numpy, no external dependencies).

The port's copy of ``whisperseg_tpu/audio/flac.py``;
it imports neither jax nor that package.

The reference ingests any container ``librosa.load`` understands (reference
datautils.py:116, segment_service.py:76-80); librosa/soundfile do not exist in
this environment, so lossless compressed ingest is implemented directly from
the FLAC format specification:

  * ``decode_flac``  — full decoder: STREAMINFO parsing, fixed & LPC
    predictors, Rice/Rice2 residuals with partitioning and escape codes,
    left/right/mid-side stereo decorrelation, wasted bits. Frame CRC fields
    are parsed and skipped, NOT verified (corruption surfaces as a parse
    error or as decoded garbage, same as most fast decoders in permissive
    mode); correctness is instead pinned by the bit-exact round-trip and
    cross-decoder tests below.
  * ``encode_flac``  — subset encoder (fixed blocking, independent channels,
    fixed predictors order 0-2, single-partition Rice residuals) used for
    round-trip tests and for producing valid .flac files. Output is standard
    FLAC, decodable by any conforming decoder.

Bit-exactness matters: FLAC is lossless, so the round-trip test asserts
EXACT int16 equality, and the decoder is additionally cross-validated against
an independent decoder (SDL_mixer via pygame) in tests/test_audio_formats.py.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["decode_flac", "encode_flac", "flac_stream_info"]


# ------------------------------------------------------------------ bit reader


class BitReader:
    """MSB-first bit reader over a byte buffer.

    Unary runs (the hot operation of Rice decoding) resolve via a precomputed
    sorted index of set-bit positions + searchsorted, so a q-length run costs
    O(log n) instead of O(q)."""

    def __init__(self, data: bytes, start_byte: int = 0):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.ones = np.flatnonzero(self.bits).astype(np.int64)
        self.pos = start_byte * 8
        self.n = len(self.bits)

    def read_uint(self, n: int) -> int:
        b = self.bits[self.pos:self.pos + n]
        if len(b) < n:
            raise EOFError("flac: bitstream truncated")
        self.pos += n
        v = 0
        for bit in b:
            v = (v << 1) | int(bit)
        return v

    def read_sint(self, n: int) -> int:
        v = self.read_uint(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        i = np.searchsorted(self.ones, self.pos)
        if i >= len(self.ones):
            raise EOFError("flac: bitstream truncated in unary run")
        one_pos = int(self.ones[i])
        q = one_pos - self.pos
        self.pos = one_pos + 1
        return q

    def read_rice(self, k: int) -> int:
        q = self.read_unary()
        r = self.read_uint(k) if k else 0
        v = (q << k) | r
        return (v >> 1) ^ -(v & 1)  # zigzag -> signed

    def align_to_byte(self):
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos // 8

    def at_eof(self) -> bool:
        return self.pos >= self.n


# ------------------------------------------------------------------ bit writer


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nacc = 0

    def write_uint(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.buf.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def write_unary(self, q: int):
        while q >= 32:
            self.write_uint(0, 32)
            q -= 32
        self.write_uint(1, q + 1)

    def write_rice(self, v: int, k: int):
        u = (v << 1) if v >= 0 else ((-v) << 1) - 1  # zigzag
        self.write_unary(u >> k)
        if k:
            self.write_uint(u & ((1 << k) - 1), k)

    def align_to_byte(self):
        if self.nacc:
            self.write_uint(0, 8 - self.nacc)

    def getvalue(self) -> bytes:
        assert self.nacc == 0
        return bytes(self.buf)


# ------------------------------------------------------------------------ CRCs


def _crc_table(poly: int, width: int):
    table = []
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        table.append(crc & mask)
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8_TABLE[crc ^ b]
    return crc


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc


# -------------------------------------------------------------------- metadata


def flac_stream_info(data: bytes) -> dict:
    """Parse the mandatory STREAMINFO block -> dict (sr, channels, bps,
    total_samples, frame start offset)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    info = None
    while True:
        if pos + 4 > len(data):
            raise ValueError("flac: truncated metadata")
        header = data[pos]
        last = bool(header & 0x80)
        btype = header & 0x7F
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:  # STREAMINFO
            br = BitReader(body)
            br.read_uint(16)  # min blocksize
            br.read_uint(16)  # max blocksize
            br.read_uint(24)  # min framesize
            br.read_uint(24)  # max framesize
            sr = br.read_uint(20)
            channels = br.read_uint(3) + 1
            bps = br.read_uint(5) + 1
            total = br.read_uint(36)
            info = {"sr": sr, "channels": channels, "bps": bps,
                    "total_samples": total}
        pos += 4 + size
        if last:
            break
    if info is None:
        raise ValueError("flac: missing STREAMINFO")
    info["frames_offset"] = pos
    return info


# ------------------------------------------------------------- frame decoding

_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_SR_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
             7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _read_utf8_number(br: BitReader) -> int:
    first = br.read_uint(8)
    if first < 0x80:
        return first
    n = 0
    while first & (0x80 >> n):
        n += 1
    v = first & (0x7F >> n)
    for _ in range(n - 1):
        v = (v << 6) | (br.read_uint(8) & 0x3F)
    return v


def _decode_residual(br: BitReader, blocksize: int, order: int) -> List[int]:
    method = br.read_uint(2)
    if method > 1:
        raise ValueError(f"flac: reserved residual method {method}")
    kbits = 4 if method == 0 else 5
    escape = (1 << kbits) - 1
    part_order = br.read_uint(4)
    nparts = 1 << part_order
    out: List[int] = []
    for p in range(nparts):
        n = (blocksize >> part_order) - (order if p == 0 else 0)
        k = br.read_uint(kbits)
        if k == escape:
            raw_bits = br.read_uint(5)
            if raw_bits == 0:
                out.extend([0] * n)
            else:
                out.extend(br.read_sint(raw_bits) for _ in range(n))
        else:
            out.extend(br.read_rice(k) for _ in range(n))
    return out


def _restore_fixed(order: int, warmup: List[int], residual: List[int]):
    """Invert the o-th-order difference: o cumulative sums seeded from the
    warmup samples' backward differences."""
    if order == 0:
        return np.asarray(residual, dtype=object)
    w = [np.asarray(warmup, dtype=object)]
    for _ in range(order):
        w.append(np.diff(w[-1]))
    x = np.asarray(residual, dtype=object)
    for k in range(order, 0, -1):
        seed = w[k - 1][-1] if len(w[k - 1]) else 0
        x = np.cumsum(np.concatenate([[seed], x]))[1:]
    return np.concatenate([np.asarray(warmup, dtype=object), x])


def _restore_lpc(warmup: List[int], coefs: List[int], shift: int,
                 residual: List[int]):
    order = len(coefs)
    out = list(warmup)
    c = coefs
    for r in residual:
        acc = 0
        m = len(out)
        for j in range(order):
            acc += c[j] * out[m - 1 - j]
        out.append(r + (acc >> shift))
    return np.asarray(out, dtype=object)


def _decode_subframe(br: BitReader, blocksize: int, bps: int):
    if br.read_uint(1) != 0:
        raise ValueError("flac: invalid subframe padding bit")
    ftype = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = br.read_unary() + 1
    bps -= wasted

    if ftype == 0:  # constant
        v = br.read_sint(bps)
        samples = np.full(blocksize, v, dtype=object)
    elif ftype == 1:  # verbatim
        samples = np.asarray([br.read_sint(bps) for _ in range(blocksize)],
                             dtype=object)
    elif 8 <= ftype <= 12:  # fixed, order 0-4
        order = ftype - 8
        warmup = [br.read_sint(bps) for _ in range(order)]
        residual = _decode_residual(br, blocksize, order)
        samples = _restore_fixed(order, warmup, residual)
    elif ftype >= 32:  # LPC, order 1-32
        order = ftype - 31
        warmup = [br.read_sint(bps) for _ in range(order)]
        precision = br.read_uint(4) + 1
        if precision == 16:
            raise ValueError("flac: invalid LPC precision")
        shift = br.read_sint(5)
        coefs = [br.read_sint(precision) for _ in range(order)]
        residual = _decode_residual(br, blocksize, order)
        samples = _restore_lpc(warmup, coefs, shift, residual)
    else:
        raise ValueError(f"flac: reserved subframe type {ftype}")

    if wasted:
        samples = samples * (1 << wasted)
    return samples


def _decode_frame(br: BitReader, info: dict):
    sync = br.read_uint(14)
    if sync != 0x3FFE:
        raise ValueError(f"flac: lost frame sync (got {sync:#x})")
    br.read_uint(1)  # reserved
    br.read_uint(1)  # blocking strategy
    bs_code = br.read_uint(4)
    sr_code = br.read_uint(4)
    ch_code = br.read_uint(4)
    bps_code = br.read_uint(3)
    br.read_uint(1)  # reserved
    _read_utf8_number(br)

    if bs_code == 6:
        blocksize = br.read_uint(8) + 1
    elif bs_code == 7:
        blocksize = br.read_uint(16) + 1
    elif bs_code in _BLOCKSIZE_TABLE:
        blocksize = _BLOCKSIZE_TABLE[bs_code]
    else:
        raise ValueError(f"flac: reserved blocksize code {bs_code}")

    if sr_code == 12:
        br.read_uint(8)
    elif sr_code in (13, 14):
        br.read_uint(16)
    # sr itself comes from STREAMINFO

    bps = info["bps"] if bps_code == 0 else _BPS_TABLE[bps_code]
    br.read_uint(8)  # header CRC8 (frame integrity also covered by CRC16)

    if ch_code <= 7:
        nch = ch_code + 1
        chans = [_decode_subframe(br, blocksize, bps) for _ in range(nch)]
    elif ch_code == 8:  # left/side
        left = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        chans = [left, left - side]
    elif ch_code == 9:  # right/side
        side = _decode_subframe(br, blocksize, bps + 1)
        right = _decode_subframe(br, blocksize, bps)
        chans = [right + side, right]
    elif ch_code == 10:  # mid/side
        mid = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        mid2 = mid * 2 + (side & 1)  # restore the dropped low bit of L+R
        chans = [(mid2 + side) // 2, (mid2 - side) // 2]
    else:
        raise ValueError(f"flac: reserved channel assignment {ch_code}")

    br.align_to_byte()
    br.read_uint(16)  # frame CRC16
    return np.stack([np.asarray(c, dtype=np.int64) for c in chans], axis=1), bps


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 array shaped (num_frames, channels) in [-1, 1), sr).

    Dispatches to the native C++ decoder (native/src/ws_flac.cpp, >100x
    faster) when built; this pure-Python implementation is the reference
    fallback, and the two are asserted bit-identical in tests."""
    from . import native

    if native.available():
        decoded = native.decode_flac(data)
        if decoded is not None:
            return decoded
    return decode_flac_py(data)


def decode_flac_py(data: bytes) -> Tuple[np.ndarray, int]:
    """Pure-Python reference decoder (see decode_flac)."""
    info = flac_stream_info(data)
    br = BitReader(data, start_byte=info["frames_offset"])
    blocks = []
    total = 0
    while not br.at_eof():
        # stop at trailing garbage / padding after the last frame
        if info["total_samples"] and total >= info["total_samples"]:
            break
        remaining = (br.n - br.pos) // 8
        if remaining < 10:
            break
        block, _bps = _decode_frame(br, info)
        blocks.append(block)
        total += block.shape[0]
    if not blocks:
        if info["total_samples"] == 0:
            # header-only stream (STREAMINFO declares zero samples) — a valid
            # empty recording, not a corrupt file
            return (np.zeros((0, info["channels"]), np.float32), info["sr"])
        raise ValueError("flac: no audio frames")
    pcm = np.concatenate(blocks, axis=0)
    if info["total_samples"]:
        pcm = pcm[: info["total_samples"]]
    scale = float(1 << (info["bps"] - 1))
    return (pcm.astype(np.float32) / scale), info["sr"]


# -------------------------------------------------------------------- encoder


def _write_utf8_number(out: BitWriter, v: int):
    """UTF-8-style coded number (FLAC frame header). ``n`` continuation bytes
    carry 6 bits each; the lead byte has ``n+1`` leading ones then a zero and
    ``8 - (n+1) - 1`` payload bits."""
    if v < 0x80:
        out.write_uint(v, 8)
        return
    n = 1
    while v >= (1 << (6 * n + (7 - (n + 1)))):
        n += 1
    nbytes = n + 1
    lead_ones = ((0xFF << (8 - nbytes)) & 0xFF)
    out.write_uint(lead_ones | (v >> (6 * n)), 8)
    for i in range(n - 1, -1, -1):
        out.write_uint(0x80 | ((v >> (6 * i)) & 0x3F), 8)


def _best_fixed_order(x: np.ndarray, max_order: int = 2) -> int:
    """Pick the fixed-predictor order minimizing the residual magnitude sum
    (the standard order-selection heuristic)."""
    best_order, best_cost = 0, None
    d = x.astype(np.int64)
    for order in range(max_order + 1):
        cost = int(np.abs(d).sum())
        if best_cost is None or cost < best_cost:
            best_cost, best_order = cost, order
        if len(d) <= 1:
            break
        d = np.diff(d)
    return best_order


def _rice_k_for(residual: np.ndarray) -> int:
    """Standard Rice parameter estimate from the mean magnitude."""
    if len(residual) == 0:
        return 0
    mean = max(float(np.abs(residual).mean()), 0.1)
    k = int(np.floor(np.log2(mean))) + 1
    return int(np.clip(k, 0, 14))


def _encode_subframe(out: BitWriter, x: np.ndarray, bps: int):
    x = x.astype(np.int64)
    order = _best_fixed_order(x)
    order = min(order, len(x))
    out.write_uint(0, 1)  # padding
    out.write_uint(8 + order, 6)  # fixed subframe of that order
    out.write_uint(0, 1)  # no wasted bits
    res = x.copy()
    for _ in range(order):
        res = np.diff(res)
    for w in x[:order]:
        out.write_uint(int(w), bps)
    k = _rice_k_for(res)
    out.write_uint(0, 2)  # 4-bit Rice method
    out.write_uint(0, 4)  # partition order 0
    out.write_uint(k, 4)
    for r in res:
        out.write_rice(int(r), k)


def encode_flac(pcm: np.ndarray, sr: int, blocksize: int = 4096) -> bytes:
    """int16 PCM (frames,) or (frames, channels) -> FLAC bytes.

    Independent channels, fixed predictors (order 0-2), one Rice partition —
    a deliberately small, correct subset of the format (every conforming
    decoder reads it; compression is within ~10-20% of the full encoder on
    typical bioacoustic recordings)."""
    if pcm.dtype != np.int16:
        if np.issubdtype(pcm.dtype, np.floating):
            pcm = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
        else:
            pcm = pcm.astype(np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, nch = pcm.shape
    assert 1 <= nch <= 8
    bps = 16

    head = BitWriter()
    head.write_uint(int.from_bytes(b"fLaC", "big"), 32)
    # STREAMINFO, last metadata block
    head.write_uint(0x80 | 0, 8)
    head.write_uint(34, 24)
    si = BitWriter()
    # min == max blocksize declares a fixed-blocksize stream (the final
    # partial block is exempt per the spec)
    si.write_uint(blocksize, 16)
    si.write_uint(blocksize, 16)
    si.write_uint(0, 24)  # min framesize unknown
    si.write_uint(0, 24)  # max framesize unknown
    si.write_uint(sr, 20)
    si.write_uint(nch - 1, 3)
    si.write_uint(bps - 1, 5)
    si.write_uint(n, 36)
    for _ in range(16):
        si.write_uint(0, 8)  # md5 unknown
    out = bytearray(head.getvalue() + si.getvalue())

    # n == 0 emits a header-only stream (STREAMINFO already says
    # total_samples = 0); an "empty frame" would encode blocksize-1 = -1
    # -> 0xFFFF and corrupt the stream
    for fi, start in enumerate(range(0, n, blocksize)):
        block = pcm[start:start + blocksize]
        bs = block.shape[0]
        fw = BitWriter()
        fw.write_uint(0x3FFE, 14)
        fw.write_uint(0, 1)  # reserved
        fw.write_uint(0, 1)  # fixed blocksize stream
        if bs == blocksize and blocksize in (256, 512, 1024, 2048, 4096,
                                             8192, 16384, 32768):
            bs_code = {256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
                       8192: 13, 16384: 14, 32768: 15}[blocksize]
            fw.write_uint(bs_code, 4)
            bs_follow = None
        else:
            fw.write_uint(7, 4)  # 16-bit blocksize-1 follows
            bs_follow = bs - 1
        fw.write_uint(0, 4)  # sample rate from STREAMINFO
        fw.write_uint(nch - 1, 4)  # independent channels
        fw.write_uint(4, 3)  # 16 bps
        fw.write_uint(0, 1)  # reserved
        _write_utf8_number(fw, fi)
        if bs_follow is not None:
            fw.write_uint(bs_follow, 16)
        # header is byte-aligned here by construction (14+1+1+4+4+4+3+1 = 32
        # bits + whole bytes), so CRC8 covers exactly these bytes
        assert fw.nacc == 0
        hb = fw.getvalue()
        frame = bytearray(hb)
        frame.append(crc8(hb))
        body = BitWriter()
        for c in range(nch):
            _encode_subframe(body, block[:, c], bps)
        body.align_to_byte()
        frame.extend(body.getvalue())
        c16 = crc16(bytes(frame))
        frame.extend(c16.to_bytes(2, "big"))
        out.extend(frame)
    return bytes(out)
