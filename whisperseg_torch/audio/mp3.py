"""From-scratch MPEG-1/2/2.5 Layer III (mp3) decoder — pure Python + numpy.

The port's copy of ``whisperseg_tpu/audio/mp3.py``;
it imports neither jax nor that package.

Closes the last delegated audio codec (FLAC and Ogg Vorbis already decode
in-repo; the reference delegates ALL formats to librosa,
reference datautils.py:116). The pipeline follows ISO 11172-3 / 13818-3:

  frame sync -> side info -> bit-reservoir main data -> scalefactors ->
  Huffman (big_values pairs + count1 quadruples) -> requantize ->
  [short-block reorder] -> stereo (MS / intensity) -> antialias ->
  hybrid IMDCT + overlap-add + frequency inversion -> polyphase synthesis

Every constant table (synthesis window, 33 Huffman codebooks, scalefactor
band edges, slen pairs, pretab) lives in ``mp3_tables.py``, RECOVERED from
the system libmpg123 by behavioral system identification — see
``scripts/mp3_oracle_extract.py`` for the derivation and its correctness
evidence. End-to-end output is validated against libmpg123 on
libmp3lame-encoded fixtures across rates/modes (tests/test_mp3.py).

Supported: MPEG-1/2/2.5 Layer III, mono + stereo (MS stereo; MPEG-1
intensity best-effort), long/short/mixed blocks, bit reservoir, free-form
ancillary data. Not supported: Layers I/II (raise), CRC verification
(skipped, like most decoders).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import mp3_tables as T
from .mp3_dsp import Synth, antialias, imdct_granule

_SR_TABLE = {3: (44100, 48000, 32000),   # MPEG-1
             2: (22050, 24000, 16000),   # MPEG-2
             0: (11025, 12000, 8000)}    # MPEG-2.5
_BR_V1 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0)
_BR_V2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 0)

_SYNTH_WINDOW = np.asarray(T.SYNTH_WINDOW_INT65536, dtype=np.float64) / 65536.0

_POW43 = np.arange(8207, dtype=np.float64) ** (4.0 / 3.0)


def _build_tree(codes):
    """codeword-bitstring -> value dict, as a nested binary tree (lists)."""
    root = [None, None]
    for bits, val in codes.items():
        node = root
        for c in bits[:-1]:
            i = int(c)
            if node[i] is None or isinstance(node[i], tuple):
                node[i] = [None, None]
            node = node[i]
        node[int(bits[-1])] = ("leaf", val)
    return root


_PAIR_TREES = {t: (lb, _build_tree(codes))
               for t, (lb, codes) in T.HUFF_PAIR_TABLES.items()}
_COUNT1_TREES = {s: _build_tree(codes) for s, codes in T.HUFF_COUNT1.items()}


class _Bits:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p, d = self.pos, self.data
        end = p + n
        if end > 8 * len(d):
            raise EOFError
        first = p >> 3
        last = (end + 7) >> 3
        val = int.from_bytes(d[first:last], "big")
        val >>= (8 * (last - first)) - (end - (first << 3))
        self.pos = end
        return val & ((1 << n) - 1)

    def read1(self) -> int:
        p = self.pos
        if p >= 8 * len(self.data):
            raise EOFError
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1


def _decode_tree(bits: _Bits, tree):
    node = tree
    while True:
        b = bits.read1()
        node = node[b]
        if node is None:
            raise ValueError("invalid Huffman code")
        if isinstance(node, tuple):
            return node[1]


# ------------------------------------------------------------ side info


class _GranuleInfo:
    __slots__ = ("part2_3_length", "big_values", "global_gain",
                 "scalefac_compress", "window_switching", "block_type",
                 "mixed_block", "table_select", "subblock_gain",
                 "region0_count", "region1_count", "preflag",
                 "scalefac_scale", "count1table_select", "scalefac_l",
                 "scalefac_s")


def _read_granule_info(b: _Bits, lsf: bool) -> _GranuleInfo:
    g = _GranuleInfo()
    g.part2_3_length = b.read(12)
    g.big_values = b.read(9)
    g.global_gain = b.read(8)
    g.scalefac_compress = b.read(9 if lsf else 4)
    g.window_switching = b.read(1)
    if g.window_switching:
        g.block_type = b.read(2)
        g.mixed_block = bool(b.read(1))
        g.table_select = (b.read(5), b.read(5), 0)
        g.subblock_gain = (b.read(3), b.read(3), b.read(3))
        # implied regions (ISO 11172-3 2.4.2.7 region_address defaults)
        g.region0_count = 8 if (g.block_type == 2 and not g.mixed_block) \
            else 7
        g.region1_count = 20 - g.region0_count
    else:
        g.block_type = 0
        g.mixed_block = False
        g.table_select = (b.read(5), b.read(5), b.read(5))
        g.subblock_gain = (0, 0, 0)
        g.region0_count = b.read(4)
        g.region1_count = b.read(3)
    g.preflag = 0 if lsf else None  # LSF: implied by scalefac decoding
    if not lsf:
        g.preflag = b.read(1)
    g.scalefac_scale = b.read(1)
    g.count1table_select = b.read(1)
    return g


# ---------------------------------------------------------- scalefactors

# MPEG-1 scfsi groups (band ranges sharing granule-0 scalefacs)
_SCFSI_BANDS = ((0, 6), (6, 11), (11, 16), (16, 21))


def _read_scalefacs_v1(b: _Bits, g: _GranuleInfo, gr: int, scfsi,
                       prev_l) -> int:
    """Fills g.scalefac_l / g.scalefac_s; returns part2 bit count."""
    s1, s2 = T.SLEN1[g.scalefac_compress], T.SLEN2[g.scalefac_compress]
    bits0 = b.pos
    if g.block_type == 2:
        g.scalefac_l = [0] * 22
        g.scalefac_s = [[0] * 13 for _ in range(3)]
        if g.mixed_block:
            for band in range(8):
                g.scalefac_l[band] = b.read(s1)
            for band in range(3, 6):
                for w in range(3):
                    g.scalefac_s[w][band] = b.read(s1)
        else:
            for band in range(6):
                for w in range(3):
                    g.scalefac_s[w][band] = b.read(s1)
        for band in range(6, 12):
            for w in range(3):
                g.scalefac_s[w][band] = b.read(s2)
    else:
        g.scalefac_l = [0] * 22
        g.scalefac_s = None
        for grp, (lo, hi) in enumerate(_SCFSI_BANDS):
            slen = s1 if hi <= 11 else s2
            if gr == 1 and scfsi[grp]:
                for band in range(lo, hi):
                    g.scalefac_l[band] = prev_l[band]
            else:
                for band in range(lo, hi):
                    g.scalefac_l[band] = b.read(slen)
    return b.pos - bits0


# LSF (MPEG-2/2.5) scalefactor partitions, ISO 13818-3 2.4.3.2
_LSF_NR = {
    0: ((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)),
    1: ((6, 5, 7, 3), (9, 9, 12, 6), (6, 9, 12, 6)),
    2: ((11, 10, 0, 0), (18, 18, 0, 0), (15, 18, 0, 0)),
}
_LSF_NR_INT = {
    0: ((7, 7, 7, 0), (12, 12, 12, 0), (6, 12, 12, 0)),
    1: ((6, 6, 6, 3), (12, 9, 9, 6), (6, 9, 9, 6)),
    2: ((8, 8, 5, 0), (15, 12, 9, 0), (6, 15, 12, 0)),
}


def _read_scalefacs_lsf(b: _Bits, g: _GranuleInfo,
                        intensity_ch: bool) -> int:
    sc = g.scalefac_compress
    int_scale = sc >> 1 if intensity_ch else sc
    if intensity_ch:
        if int_scale < 180:
            slen = (int_scale // 36, (int_scale % 36) // 6, int_scale % 6, 0)
            part = 0
        elif int_scale < 244:
            s = int_scale - 180
            slen = ((s % 64) >> 4, (s % 16) >> 2, s & 3, 0)
            part = 1
        else:
            s = int_scale - 244
            slen = (s // 3, s % 3, 0, 0)
            part = 2
        nr_tab = _LSF_NR_INT[part]
        g.preflag = 0
    else:
        if int_scale < 400:
            slen = ((int_scale >> 4) // 5, (int_scale >> 4) % 5,
                    (int_scale >> 2) & 3, int_scale & 3)
            part = 0
            g.preflag = 0
        elif int_scale < 500:
            s = int_scale - 400
            slen = ((s >> 2) // 5, (s >> 2) % 5, s & 3, 0)
            part = 1
            g.preflag = 0
        else:
            s = int_scale - 500
            slen = (s // 3, s % 3, 0, 0)
            part = 2
            g.preflag = 1
        nr_tab = _LSF_NR[part]
    if g.block_type == 2:
        nr = nr_tab[2] if g.mixed_block else nr_tab[1]
    else:
        nr = nr_tab[0]

    bits0 = b.pos
    raw = []
    for group in range(4):
        for _ in range(nr[group]):
            raw.append(b.read(slen[group]))
    it = iter(raw + [0] * 60)
    if g.block_type == 2:
        g.scalefac_l = [0] * 22
        g.scalefac_s = [[0] * 13 for _ in range(3)]
        if g.mixed_block:
            for band in range(6):
                g.scalefac_l[band] = next(it)
            for band in range(3, 12):
                for w in range(3):
                    g.scalefac_s[w][band] = next(it)
        else:
            for band in range(12):
                for w in range(3):
                    g.scalefac_s[w][band] = next(it)
    else:
        g.scalefac_l = [0] * 22
        g.scalefac_s = None
        for band in range(21):
            g.scalefac_l[band] = next(it)
    return b.pos - bits0


# ------------------------------------------------------------- huffman


def _decode_spectrum(b: _Bits, g: _GranuleInfo, sfb_long, sfb_short,
                     bit_limit):
    """Huffman-decode 576 integer spectral values (Huffman order).

    bit_limit: absolute bit position where this granule's part2_3 data ends
    (= part2 start + part2_3_length); the count1 loop runs until it."""
    raw = np.zeros(576, dtype=np.float64)
    limit = bit_limit
    if g.window_switching:
        # window-switching granules transmit no region counts; the implied
        # region0 spans 9 short-triplet bands (3 * sfb_short[3]) for short
        # blocks and 8 long bands (sfb_long[8]) for start/stop/mixed.
        # Confirmed against libmpg123 at 8 kHz, the one rate where these
        # differ from the literal 36 (dbg: bt2=s3x3 + bt13=l8 -> 1.7e-6,
        # every other combination fails by 6+ orders of magnitude)
        if g.block_type == 2 and not g.mixed_block:
            region1_start = 3 * sfb_short[3]
        else:
            region1_start = sfb_long[8]
        region2_start = 576
    else:
        region1_start = sfb_long[g.region0_count + 1]
        region2_start = sfb_long[min(g.region0_count + g.region1_count + 2,
                                     22)]
    idx = 0
    for pair in range(g.big_values):
        if idx >= 576:
            break
        if idx < region1_start:
            tsel = g.table_select[0]
        elif idx < region2_start:
            tsel = g.table_select[1]
        else:
            tsel = g.table_select[2]
        if tsel == 0 or tsel == 4 or tsel == 14:
            idx += 2
            continue
        linbits, tree = _PAIR_TREES[tsel]
        x, y = _decode_tree(b, tree)
        if x == 15 and linbits:
            x += b.read(linbits)
        if x:
            if b.read1():
                x = -x
        if y == 15 and linbits:
            y += b.read(linbits)
        if y:
            if b.read1():
                y = -y
        raw[idx] = np.sign(x) * _POW43[abs(x)]
        raw[idx + 1] = np.sign(y) * _POW43[abs(y)]
        idx += 2
    # count1 region
    tree = _COUNT1_TREES[g.count1table_select]
    while b.pos < limit and idx + 4 <= 576:
        start = b.pos
        try:
            quad = _decode_tree(b, tree)
            vals = []
            for v in quad:
                if v:
                    vals.append(-1.0 if b.read1() else 1.0)
                else:
                    vals.append(0.0)
        except (EOFError, ValueError):
            b.pos = start
            break
        if b.pos > limit:
            # the last quadruple overran the budget: discard it
            b.pos = start
            break
        raw[idx: idx + 4] = vals
        idx += 4
    return raw, idx  # idx = zero-part start (Huffman-order)


# ---------------------------------------------------------- requantize


def _requantize(g: _GranuleInfo, raw, sfb_long, sfb_short):
    xr = np.zeros(576)
    scale_step = 0.5 * (1 + g.scalefac_scale)
    gg = g.global_gain
    if g.block_type == 2:
        # short (or mixed): requantize in Huffman order, then reorder
        long_part = 36 if g.mixed_block else 0
        if long_part:
            gain = 2.0 ** ((gg - 210) / 4.0)
            for band in range(8):
                lo, hi = sfb_long[band], sfb_long[band + 1]
                if lo >= long_part:
                    break
                hi = min(hi, long_part)
                pre = T.PRETAB[band] if g.preflag else 0
                att = 2.0 ** (-scale_step * (g.scalefac_l[band] + pre))
                xr[lo:hi] = raw[lo:hi] * gain * att
        first_band = 3 if g.mixed_block else 0
        idx = long_part
        for band in range(first_band, 13):
            lo, hi = sfb_short[band], sfb_short[band + 1]
            width = hi - lo
            for w in range(3):
                gain = 2.0 ** ((gg - 210) / 4.0 - 2.0 * g.subblock_gain[w])
                sf = g.scalefac_s[w][band] if band < 12 else 0
                att = 2.0 ** (-scale_step * sf)
                vals = raw[idx: idx + width] * gain * att
                # reorder: window-interleave within each 18-line subband
                for i in range(width):
                    line = lo + i
                    if line >= 192:
                        break
                    dst = (line // 6) * 18 + (line % 6) * 3 + w
                    xr[dst] = vals[i]
                idx += width
                if idx >= 576:
                    break
            if idx >= 576:
                break
    else:
        gain = 2.0 ** ((gg - 210) / 4.0)
        for band in range(22):
            lo = sfb_long[band]
            hi = sfb_long[band + 1] if band < 22 else 576
            pre = T.PRETAB[band] if g.preflag else 0
            sf = g.scalefac_l[band] if band < 21 else 0
            att = 2.0 ** (-scale_step * (sf + pre))
            xr[lo:hi] = raw[lo:hi] * gain * att
    return xr


# -------------------------------------------------------------- stereo


def _apply_stereo(mode_ext, gr_infos, xr, zero_start, sfb_long, sfb_short,
                  lsf):
    """In-place MS / intensity processing on xr[0] (left/mid), xr[1]."""
    ms = bool(mode_ext & 2)
    intensity = bool(mode_ext & 1)
    if ms:
        sq = np.sqrt(2.0)
        m = xr[0].copy()
        s = xr[1]
        xr[0][:] = (m + s) / sq
        xr[1][:] = (m - s) / sq
    if not intensity:
        return
    # intensity bands: scalefactor bands entirely above the right channel's
    # decoded extent
    g = gr_infos[1]
    bound = zero_start[1]
    if g.block_type == 2:
        return  # short-block intensity: rare; left unprocessed
    for band in range(21, -1, -1):
        lo = sfb_long[band]
        hi = sfb_long[band + 1] if band < 22 else 576
        if lo < bound:
            break
        is_pos = g.scalefac_l[band] if band < 21 else 7
        if lsf:
            if is_pos == 0:
                continue
            k = 2.0 ** (-((is_pos + 1) // 2) / (2.0 if (is_pos & 1) else 1.0))
            kl, kr = (k, 1.0) if (is_pos & 1) else (1.0, k)
        else:
            if is_pos == 7:
                continue
            ratio = np.tan(is_pos * np.pi / 12.0)
            kl = ratio / (1.0 + ratio)
            kr = 1.0 / (1.0 + ratio)
        mid = xr[0][lo:hi].copy()
        xr[0][lo:hi] = mid * kl
        xr[1][lo:hi] = mid * kr


# ------------------------------------------------------------- decoder


class _ChannelState:
    def __init__(self):
        self.overlap = np.zeros((32, 18))
        self.synth = Synth(_SYNTH_WINDOW)


def _granule_to_pcm(g: _GranuleInfo, xr, state: _ChannelState):
    n_borders = 0 if (g.block_type == 2 and not g.mixed_block) \
        else (1 if g.block_type == 2 else 31)
    antialias(xr, n_borders)
    ss = np.empty((18, 32))
    for sb in range(32):
        bt = g.block_type
        if g.mixed_block and sb < 2:
            bt = 0
        block = imdct_granule(xr[sb * 18:(sb + 1) * 18], bt)
        ss[:, sb] = block[:18] + state.overlap[sb]
        state.overlap[sb] = block[18:]
    for sb in range(1, 32, 2):
        ss[1::2, sb] *= -1.0
    out = np.empty(576)
    for t in range(18):
        out[t * 32:(t + 1) * 32] = state.synth.step(ss[t])
    return out


def _find_frame(data: bytes, pos: int) -> Optional[tuple]:
    """Scan for the next valid Layer III header; returns parsed fields."""
    n = len(data)
    while pos + 4 <= n:
        if data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0:
            b1, b2, b3 = data[pos + 1], data[pos + 2], data[pos + 3]
            version = (b1 >> 3) & 3
            layer = (b1 >> 1) & 3
            br_idx = (b2 >> 4) & 0xF
            sr_idx = (b2 >> 2) & 3
            if version != 1 and layer == 1 and br_idx not in (0, 15) \
                    and sr_idx != 3:
                protection = b1 & 1
                padding = (b2 >> 1) & 1
                mode = (b3 >> 6) & 3
                mode_ext = (b3 >> 4) & 3
                sr = _SR_TABLE[version][sr_idx]
                lsf = version != 3
                bitrate = (_BR_V2 if lsf else _BR_V1)[br_idx] * 1000
                per = 72 if lsf else 144
                frame_len = per * bitrate // sr + padding
                if frame_len > 4:
                    return (pos, version, lsf, sr, mode, mode_ext,
                            protection, frame_len)
        pos += 1
    return None


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """MP3 bytes -> (float32 [frames, channels], sr)."""
    if data[:3] == b"ID3":
        size = ((data[6] & 0x7F) << 21 | (data[7] & 0x7F) << 14
                | (data[8] & 0x7F) << 7 | (data[9] & 0x7F))
        data = data[10 + size:]

    pos = 0
    out_sr = None
    n_ch = None
    states = None
    reservoir = b""
    chunks = []
    while True:
        fr = _find_frame(data, pos)
        if fr is None:
            break
        (pos, version, lsf, sr, mode, mode_ext, protection, frame_len) = fr
        frame = data[pos: pos + frame_len]
        if len(frame) < frame_len:
            break
        pos += frame_len
        if out_sr is None:
            out_sr = sr
            n_ch = 1 if mode == 3 else 2
            states = [_ChannelState() for _ in range(n_ch)]
        elif sr != out_sr or (1 if mode == 3 else 2) != n_ch:
            break  # stream parameter change: stop

        hdr_len = 4 + (0 if protection else 2)
        side_len = (9 if n_ch == 1 else 17) if lsf \
            else (17 if n_ch == 1 else 32)
        side = _Bits(frame[hdr_len: hdr_len + side_len])
        try:
            main_data_begin = side.read(8 if lsf else 9)
            side.read((1 if n_ch == 1 else 2) if lsf
                      else (5 if n_ch == 1 else 3))
            scfsi = [[0] * 4 for _ in range(n_ch)]
            if not lsf:
                for ch in range(n_ch):
                    for grp in range(4):
                        scfsi[ch][grp] = side.read(1)
            n_gr = 1 if lsf else 2
            infos = [[_read_granule_info(side, lsf) for _ in range(n_ch)]
                     for _ in range(n_gr)]
        except EOFError:
            continue

        frame_main = frame[hdr_len + side_len:]
        if main_data_begin > len(reservoir):
            # reservoir underrun (cut stream): skip frame, keep accumulating
            reservoir = (reservoir + frame_main)[-511:]
            chunks.append(np.zeros((1152 // (2 if lsf else 1), n_ch),
                                   dtype=np.float64))
            continue
        main = (reservoir[len(reservoir) - main_data_begin:]
                if main_data_begin else b"") + frame_main
        reservoir = (reservoir + frame_main)[-511:]
        bits = _Bits(main)

        sfb_long = T.SFB_LONG[sr]
        sfb_short = T.SFB_SHORT[sr]
        frame_pcm = np.zeros((n_gr * 576, n_ch), dtype=np.float64)
        prev_l = [None] * n_ch
        for gr in range(n_gr):
            xrs = []
            zero_start = []
            for ch in range(n_ch):
                g = infos[gr][ch]
                part2_start = bits.pos
                try:
                    if lsf:
                        intensity_ch = (ch == 1 and bool(mode_ext & 1))
                        _read_scalefacs_lsf(bits, g, intensity_ch)
                    else:
                        _read_scalefacs_v1(bits, g, gr, scfsi[ch],
                                           prev_l[ch])
                        prev_l[ch] = g.scalefac_l
                    raw, zstart = _decode_spectrum(
                        bits, g, sfb_long, sfb_short,
                        part2_start + g.part2_3_length)
                    xr = _requantize(g, raw, sfb_long, sfb_short)
                except (EOFError, ValueError, IndexError):
                    xr = np.zeros(576)
                    zstart = 0
                    g.scalefac_l = [0] * 22
                    g.scalefac_s = [[0] * 13 for _ in range(3)]
                bits.pos = part2_start + g.part2_3_length
                xrs.append(xr)
                zero_start.append(zstart)
            if n_ch == 2 and mode == 1:
                _apply_stereo(mode_ext, infos[gr], xrs, zero_start,
                              sfb_long, sfb_short, lsf)
            for ch in range(n_ch):
                frame_pcm[gr * 576:(gr + 1) * 576, ch] = _granule_to_pcm(
                    infos[gr][ch], xrs[ch], states[ch])
        chunks.append(frame_pcm)

    if not chunks:
        raise ValueError("no Layer III frames found")
    pcm = np.concatenate(chunks, axis=0)
    return np.clip(pcm, -1.0, 1.0).astype(np.float32), out_sr
