"""The port's audio containers (``whisperseg_torch/audio/``: ``flac.py``,
``formats.py``, ``io.py``, ``native.py``, the MP3 chain, ``vorbis.py``,
``opus.py`` and ``mpg123.py``) against the JAX package's, on audio made here
from a seed.

Every decode is compared bit for bit: FLAC encoded by both packages' encoder
(same bytes) and decoded by the native and the pure-Python decoder; MP3
streams written bit by bit (``synthetic.crafted_mp3``) and by libmp3lame as
``tests/test_mp3.py`` makes them; Ogg Vorbis from libvorbisenc as
``tests/test_vorbis.py`` makes it and Ogg Opus from the module's own page
writer as ``tests/test_opus.py`` does, skipping exactly when those tests
skip. ``sniff_format``, the header probes, ``get_sampling_rate``,
``get_audio_duration`` and ``load_audio`` (with resampling, ``mono=False``
and ``channel_id``) agree on every format, and the port's native library is
built into ``whisperseg_torch/_build/`` and decodes and resamples as the
JAX package's does. Clips are 1 s or less.
"""

import io
import os
import sys
import wave

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import lame_encode  # noqa: E402
from whisperseg_tpu.audio import flac as jflac  # noqa: E402
from whisperseg_tpu.audio import formats as jformats  # noqa: E402
from whisperseg_tpu.audio import io as jio  # noqa: E402
from whisperseg_tpu.audio import mp3 as jmp3  # noqa: E402
from whisperseg_tpu.audio import mpg123 as jmpg123  # noqa: E402
from whisperseg_tpu.audio import native as jnative  # noqa: E402
from whisperseg_tpu.audio import opus as jopus  # noqa: E402
from whisperseg_tpu.audio import vorbis as jvorbis  # noqa: E402
from whisperseg_torch.audio import (flac, formats, mp3, mpg123,  # noqa: E402
                                    native, opus, vorbis)
from whisperseg_torch.audio import io as tio  # noqa: E402
from whisperseg_torch.synthetic import (crafted_mp3, pcm16,  # noqa: E402
                                        tone_bursts)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(a, b):
    """Same rate, and the same samples bit for bit."""
    (x, sx), (y, sy) = a, b
    assert sx == sy
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


def _stereo(seed, sr, seconds=1.0):
    left = tone_bursts(seed, sr=sr, duration=seconds)
    return np.stack([left, -0.5 * left[::-1]], axis=1)


def _wav(y, sr):
    pcm = pcm16(y)
    pcm = pcm[:, None] if pcm.ndim == 1 else pcm
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _ogg_vorbis(y, sr):
    from test_vorbis import encode_ogg  # skips when libvorbisenc is absent

    return encode_ogg(np.asarray(y, np.float32).reshape(len(y), -1), sr)


def _mp3_lame(y, sr, kbps=64):
    if not lame_encode.available():
        pytest.skip("libmp3lame not available")
    y = np.asarray(y, np.float64)
    return lame_encode.encode(y, sr, kbps, mode=3 if y.ndim == 1 else 1)


_needs_opus = pytest.mark.skipif(not jopus.available(),
                                 reason="libopus not available")


# ------------------------------------------------------------------ FLAC


@pytest.mark.parametrize("sr,channels", [(16000, 1), (32000, 2)])
def test_flac_encode_and_decode_bit_identical(sr, channels):
    y = tone_bursts(1, sr=sr, duration=1.0) if channels == 1 \
        else _stereo(2, sr)
    data = flac.encode_flac(pcm16(y), sr, blocksize=1152)
    assert data == jflac.encode_flac(pcm16(y), sr, blocksize=1152)
    want = jflac.decode_flac_py(data)
    _equal(flac.decode_flac_py(data), want)
    _equal(flac.decode_flac(data), want)  # the native decoder, when built
    assert flac.flac_stream_info(data) == jflac.flac_stream_info(data)
    np.testing.assert_array_equal(
        want[0], pcm16(y).reshape(len(y), -1).astype(np.float32) / 32768.0)


# ------------------------------------------------------------------- MP3


@pytest.mark.parametrize("sr", [32000, 44100])
def test_crafted_mp3_decodes_bit_identical(sr):
    data = crafted_mp3(5, duration=1.0, sr=sr)
    want = jmp3.decode_mp3(data)
    assert want[1] == sr and np.abs(want[0]).max() > 0.01
    _equal(mp3.decode_mp3(data), want)
    _equal(formats.decode_compressed(data), jformats.decode_compressed(data))


@pytest.mark.parametrize("sr,channels", [(16000, 1), (44100, 2)])
def test_lame_mp3_decodes_bit_identical(sr, channels):
    y = tone_bursts(3, sr=sr, duration=1.0) if channels == 1 \
        else _stereo(4, sr)
    data = _mp3_lame(y, sr)
    _equal(mp3.decode_mp3(data), jmp3.decode_mp3(data))
    assert mpg123.available() == jmpg123.available()
    if mpg123.available():
        _equal(mpg123.decode_mp3(data), jmpg123.decode_mp3(data))


# ------------------------------------------------------------------- Ogg


def test_ogg_vorbis_decodes_bit_identical():
    y = tone_bursts(6, sr=16000, duration=1.0)
    data = _ogg_vorbis(y, 16000)
    _equal(vorbis.decode_ogg_vorbis(data), jvorbis.decode_ogg_vorbis(data))
    _equal(formats.decode_compressed(data), jformats.decode_compressed(data))


def test_opus_available_as_the_jax_package_reports():
    assert opus.available() == jopus.available()
    assert not opus.looks_like_ogg_opus(b"OggS" + b"\x00" * 30)


@_needs_opus
def test_ogg_opus_decodes_bit_identical():
    pcm = np.stack([tone_bursts(7, sr=48000, duration=0.5)] * 2, axis=1)
    data = opus._encode_ogg_opus(pcm, channels=2)
    assert data == jopus._encode_ogg_opus(pcm, channels=2)
    assert opus.looks_like_ogg_opus(data)
    _equal(opus.decode_ogg_opus(data), jopus.decode_ogg_opus(data))
    _equal(formats.decode_compressed(data), jformats.decode_compressed(data))


# ------------------------------------------------- sniffing, probes, load


def _files(tmp_path):
    """{format: path} of one recording in each container the tests can
    make here."""
    y16 = tone_bursts(8, sr=16000, duration=1.0)
    made = {"wav": _wav(_stereo(9, 22050), 22050),
            "flac": flac.encode_flac(pcm16(_stereo(10, 32000)), 32000),
            "mp3": crafted_mp3(11, duration=1.0, sr=48000)}
    if lame_encode.available():
        made["mp3_stereo"] = lame_encode.encode(
            np.asarray(_stereo(12, 44100), np.float64), 44100, 96, mode=1)
    try:
        made["ogg"] = _ogg_vorbis(y16, 16000)
    except BaseException as e:  # pytest.skip: libvorbisenc is absent
        if type(e).__name__ != "Skipped":
            raise
    if jopus.available():
        made["opus"] = opus._encode_ogg_opus(
            tone_bursts(13, sr=48000, duration=0.5)[:, None])
    paths = {}
    for name, data in made.items():
        ext = {"mp3_stereo": "mp3", "opus": "ogg"}.get(name, name)
        paths[name] = str(tmp_path / f"{name}.{ext}")
        with open(paths[name], "wb") as f:
            f.write(data)
    return paths


def test_sniffing_and_probes_agree_on_every_format(tmp_path):
    paths = _files(tmp_path)
    assert {"wav", "flac", "mp3"} <= set(paths)
    for name, path in paths.items():
        with open(path, "rb") as f:
            data = f.read()
        fmt = formats.sniff_format(data)
        assert fmt == jformats.sniff_format(data) != "unknown", name
        assert tio.get_sampling_rate(path) == jio.get_sampling_rate(path)
        assert tio.get_audio_duration(path) == jio.get_audio_duration(path)
        if fmt != "wav":
            assert formats.probe_sampling_rate(data) == \
                jformats.probe_sampling_rate(data)
            assert formats.probe_duration(data) == \
                jformats.probe_duration(data)
        if fmt == "mp3":
            assert formats.mp3_stream_info(data) == \
                jformats.mp3_stream_info(data)
        if fmt == "ogg":
            assert formats.ogg_stream_info(data) == \
                jformats.ogg_stream_info(data)
    assert formats.sniff_format(b"\x00" * 16) == "unknown" == \
        jformats.sniff_format(b"\x00" * 16)
    with pytest.raises(ValueError):
        formats.probe_duration(b"\x00" * 16)


@pytest.mark.parametrize("kwargs", [{}, {"sr": 16000},
                                    {"sr": 16000, "channel_id": 1},
                                    {"mono": False}])
def test_load_audio_identical_to_jax(tmp_path, kwargs):
    paths = _files(tmp_path)
    for name, path in paths.items():
        got = tio.load_audio(path, **kwargs)
        _equal(got, jio.load_audio(path, **kwargs))
        with open(path, "rb") as f:  # bytes and file objects too
            data = f.read()
        _equal(tio.load_audio(data, **kwargs), got)
        _equal(tio.load_audio(io.BytesIO(data), **kwargs), got)


# ---------------------------------------------------------------- native


def test_native_library_built_in_the_port_and_equal_to_jax():
    assert native.available() and jnative.available()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "whisperseg_torch",
                                                 "_build")
    assert os.path.exists(path)
    y = _stereo(14, 32000)
    wav = _wav(y, 32000)
    _equal(native.decode_wav(wav), jnative.decode_wav(wav))
    data = flac.encode_flac(pcm16(y), 32000)
    _equal(native.decode_flac(data), jnative.decode_flac(data))
    _equal(native.decode_flac(data), flac.decode_flac_py(data))
    mono = np.ascontiguousarray(y[:, 0])
    for sr_out in (16000, 44100, 22050):
        got = native.resample(mono, 32000, sr_out)
        np.testing.assert_array_equal(got, jnative.resample(mono, 32000,
                                                            sr_out))
        np.testing.assert_array_equal(tio.resample(mono, 32000, sr_out), got)
    assert native.decode_wav(b"not a wav") is None


def test_read_wav_of_every_pcm_width_equal_to_jax():
    y = _stereo(15, 8000, seconds=0.25)
    for width in (1, 2, 3, 4):
        scale = 2 ** (8 * width - 1) - 1
        ints = np.round(y * scale).astype(np.int64)
        if width == 1:
            raw = (ints + 128).astype(np.uint8).tobytes()
        else:
            raw = b"".join(int(v).to_bytes(width, "little", signed=True)
                           for v in ints.reshape(-1))
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(width)
            w.setframerate(8000)
            w.writeframes(raw)
        _equal(tio.read_wav(buf.getvalue()), jio.read_wav(buf.getvalue()))
