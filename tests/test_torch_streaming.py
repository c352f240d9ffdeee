"""Streaming and the segment CLI of the port.

``audio/stream.py``: chunks of ``AudioStream`` equal ``load_audio``'s audio,
resampled too, with a ragged tail and with channel selection, and
compressed files (FLAC, MP3, Ogg) as the JAX package's stream does. ``Segmenter.segment_streaming``: the table of ``segment()`` /
``segment_from_frames()`` on the same file, and of the JAX package's
``segment_streaming``. ``whisperseg_torch.cli.segment.main``: the CSV bytes
of ``whisperseg_tpu.cli.segment.main`` for ``--audio_path``,
``--audio_folder``, ``--streaming 1`` and ``--frame_mode 1`` (the shipped
tiny checkpoint, with a config that sets float32 compute, in both).
"""

import ctypes.util
import io
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from whisperseg_tpu.audio.stream import AudioStream as JaxAudioStream
from whisperseg_tpu.cli import segment as jax_cli
from whisperseg_tpu.segmenter import Segmenter as JaxSegmenter
from whisperseg_torch.audio.flac import encode_flac
from whisperseg_torch.audio.io import load_audio, save_wav
from whisperseg_torch.audio.stream import AudioStream
from whisperseg_torch.cli import segment as cli
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import crafted_mp3, pcm16, tone_bursts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port on one CPU thread while this module runs: the test suite
    runs several processes at once, and torch's thread pool in each of them
    would otherwise contend for the same cores (the results do not depend
    on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_wav(path, seconds, sr, channels=1, seed=0):
    rng = np.random.RandomState(seed)
    y = (rng.randn(int(seconds * sr), channels) * 0.1).clip(-0.99, 0.99)
    save_wav(path, y.astype(np.float32), sr)
    return path


def _streamed(path, **kw):
    with AudioStream(path, **kw) as s:
        chunks = list(s)
        sr = s.sr
    return (np.concatenate(chunks) if chunks else np.zeros(0, np.float32)), sr


# ------------------------------------------------------------------ raw stream


@pytest.mark.parametrize("seconds,native,target,chunk,channels", [
    (7.3, 16000, None, 2, 2),      # same rate, two channels mixed
    (5.13, 44100, 32000, 2, 1),    # downsampled, bit-exact across chunks
    (4.777, 16000, 44100, 3, 1),   # upsampled, ragged tail
])
def test_stream_equals_load_audio(tmp_path, seconds, native, target, chunk,
                                  channels):
    path = _write_wav(str(tmp_path / "a.wav"), seconds, native, channels)
    want, want_sr = load_audio(path, sr=target)
    got, sr = _streamed(path, sr=target, chunk_seconds=chunk)
    assert sr == want_sr == (target or native)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_stream_float_wav_and_channel_select(tmp_path):
    import struct

    sr, n = 8000, 8000 * 3 + 123
    y = (np.random.RandomState(1).randn(n, 2) * 0.1).astype(np.float32)
    raw = y.astype("<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 2, sr, sr * 8, 8, 32)
    data = (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(raw))
            + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(raw)) + raw)
    path = str(tmp_path / "f.wav")
    with open(path, "wb") as f:
        f.write(data)
    want, _ = load_audio(path, channel_id=1)
    got, _ = _streamed(path, chunk_seconds=1, channel_id=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, y[:, 1])


def test_stream_refuses_compressed_files(tmp_path):
    """Compressed containers (FLAC, MP3, Ogg Vorbis) are no longer refused:
    decoded whole and served in chunks, they stream like the JAX package's
    ``AudioStream``, with resampling and ``channel_id``, and equal
    ``load_audio``."""
    y = np.stack([tone_bursts(30, sr=16000, duration=1.0),
                  tone_bursts(31, sr=16000, duration=1.0)], axis=1)
    streams = {"flac": encode_flac(pcm16(y), 16000),
               "mp3": crafted_mp3(32, duration=1.0, sr=32000)}
    if all(ctypes.util.find_library(n) for n in ("vorbis", "vorbisenc", "ogg")):
        from test_vorbis import encode_ogg

        streams["ogg"] = encode_ogg(y, 16000)
    for fmt, blob in streams.items():
        path = str(tmp_path / f"a.{fmt}")
        with open(path, "wb") as f:
            f.write(blob)
        for kw in ({}, {"sr": 8000, "channel_id": 1}):
            got, sr = _streamed(path, chunk_seconds=1, **kw)
            with JaxAudioStream(path, chunk_seconds=1, **kw) as s:
                want = np.concatenate(list(s))
                assert s.sr == sr
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, load_audio(path, sr=kw.get("sr"),
                                channel_id=kw.get("channel_id"))[0])


# ------------------------------------------------------- streaming segmentation


@pytest.fixture(scope="module")
def float32_checkpoint(tmp_path_factory):
    """The shipped tiny checkpoint with a config that computes in float32
    (the weights file linked, not copied)."""
    root = str(tmp_path_factory.mktemp("tiny_f32"))
    os.symlink(os.path.join(TINY, "params.npz"),
               os.path.join(root, "params.npz"))
    with open(os.path.join(TINY, "config.json")) as f:
        config = json.load(f)
    config["compute_dtype"] = "float32"
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    return root


@pytest.fixture(scope="module")
def segmenters(float32_checkpoint):
    """One JAX and one port Segmenter for the whole module: each new JAX
    one compiles its programs again."""
    return (JaxSegmenter.from_pretrained(float32_checkpoint,
                                         inference_dtype="float32"),
            Segmenter.from_pretrained(float32_checkpoint,
                                      inference_dtype="float32", device="cpu"))


@pytest.fixture(scope="module")
def tone_file(tmp_path_factory):
    """6.3 s of tone bursts as a 16-bit WAV file, and its audio."""
    path = str(tmp_path_factory.mktemp("stream") / "tones.wav")
    save_wav(path, tone_bursts(40, duration=6.3), 32000)
    return path, load_audio(path)[0]


# the energy post-processing needs the whole audio and streaming skips it
WHOLE_FILE_ONLY = dict(refine_boundaries_ms=0, split_merged_db=0)


@pytest.mark.parametrize("num_trials,num_beams", [(1, 4), (3, 1)])
def test_segment_streaming_equals_segment(segmenters, tone_file, num_trials,
                                          num_beams):
    """Beam 4, and 3 trials (whose carry buffers start with each trial's
    shifted left pad) also against the JAX package's streaming."""
    jseg, seg = segmenters
    path, audio = tone_file
    kw = dict(num_trials=num_trials, num_beams=num_beams, batch_size=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # low cross-trial agreement
        want = seg.segment(audio, 32000, **WHOLE_FILE_ONLY, **kw)
        got = seg.segment_streaming(path, chunk_seconds=2, **kw)
        if num_trials > 1:
            assert got == jseg.segment_streaming(path, chunk_seconds=2, **kw)
    assert len(want["onset"]) >= 5, want
    assert got == want


def test_segment_streaming_frame_mode(segmenters, tone_file):
    jseg, seg = segmenters
    path, audio = tone_file
    want = seg.segment_from_frames(audio, 32000, batch_size=3)
    got = seg.segment_streaming(path, chunk_seconds=2, frame_mode=True,
                                batch_size=3)
    assert len(want["onset"]) >= 10, want
    assert got == want
    assert got == jseg.segment_streaming(path, chunk_seconds=2,
                                         frame_mode=True, batch_size=3)


def test_segment_streaming_empty_file(segmenters, tmp_path):
    seg = segmenters[1]
    path = str(tmp_path / "e.wav")
    save_wav(path, np.zeros(0, np.float32), 32000)
    want = seg.segment(np.zeros(0, np.float32), 32000, num_beams=1,
                       **WHOLE_FILE_ONLY)
    assert seg.segment_streaming(path, num_beams=1) == want


# ------------------------------------------------------------------------- CLI


@pytest.fixture
def jax_cli_segmenter(monkeypatch, float32_checkpoint, segmenters):
    """The JAX CLI loads its Segmenter anew at each call: here every call
    gets the module's."""
    def from_pretrained(model_path, inference_dtype="bfloat16"):
        assert (model_path, inference_dtype) == (float32_checkpoint, "float32")
        return segmenters[0]
    monkeypatch.setattr(JaxSegmenter, "from_pretrained", from_pretrained)


@pytest.fixture(scope="module")
def audio_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("folder")
    for i, seconds in enumerate((4.1, 2.5)):
        save_wav(str(folder / f"rec_{i}.WAV"), tone_bursts(50 + i,
                                                           duration=seconds),
                 32000)
    save_wav(str(folder / "quiet.wav"), np.zeros(16000, np.float32), 32000)
    (folder / "notes.txt").write_text("not audio")
    return str(folder)


# both CLIs at the streaming tests' batch of 3 windows: the JAX segmenter
# reuses the programs it compiled for them, and the port decodes no
# padded rows beyond a third window
CLI = ["--compute_type", "float32", "--batch_size", "3"]


def _csv_bytes(main, argv, out):
    main(argv + ["--csv_save_path", out])
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("extra", [
    ["--num_trials", "3", "--num_beams", "1"],
    ["--frame_mode", "1"],
    ["--streaming", "1", "--chunk_seconds", "2", "--num_beams", "1"],
], ids=["path", "frame_mode", "streaming"])
def test_cli_csv_bytes_identical_to_jax(tmp_path, float32_checkpoint,
                                        audio_folder, jax_cli_segmenter,
                                        extra):
    argv = ["--model_path", float32_checkpoint, *CLI,
            "--audio_path", os.path.join(audio_folder, "rec_0.WAV"), *extra]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _csv_bytes(jax_cli.main, argv, str(tmp_path / "jax.csv"))
        got = _csv_bytes(cli.main, argv + ["--device", "cpu"],
                         str(tmp_path / "port.csv"))
    assert want.count(b"\n") >= 4, want
    assert got == want


def test_cli_folder_and_buffer_identical_to_jax(tmp_path, float32_checkpoint,
                                                audio_folder, jax_cli_segmenter,
                                                capsys):
    argv = ["--model_path", float32_checkpoint, *CLI,
            "--audio_folder", audio_folder, "--num_beams", "1",
            "--csv_save_path", "buffer"]
    jax_cli.main(argv)
    want = capsys.readouterr().out
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert want.startswith("filename,onset,offset,cluster\n")
    assert {"rec_0.WAV", "rec_1.WAV"} <= {row.split(",")[0]
                                          for row in want.splitlines()[1:]}
    assert got == want


def test_cli_empty_table_and_stdin(tmp_path, float32_checkpoint, audio_folder,
                                   jax_cli_segmenter, monkeypatch):
    quiet = os.path.join(audio_folder, "quiet.wav")
    argv = ["--model_path", float32_checkpoint, *CLI,
            "--num_beams", "1"]
    want = _csv_bytes(jax_cli.main, argv + ["--audio_path", quiet],
                      str(tmp_path / "jax.csv"))
    with open(quiet, "rb") as f:
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(f.read())))
    got = _csv_bytes(cli.main, argv + ["--audio_path", "-", "--device", "cpu"],
                     str(tmp_path / "port.csv"))
    assert want == b"onset,offset,cluster\n"
    assert got == want
