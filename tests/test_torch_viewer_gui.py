"""The port's spectrogram viewer (``whisperseg_torch/audio/viewer.py``) and
browser GUI (``services/gui.py``) against the JAX package's, on the CPU.

``SpecViewer`` renders the image the JAX viewer renders: its spectrogram
from the port's batched frontend, and the colormap's input, within 1e-4 of
the JAX viewer's float64 ones; the prediction and label bars and frame-head
strips within 1e-4; the spectrogram's colours the same but for rare pixels
one entry of the 256-colour map apart. The GUI's pages hold the same
elements and call the same endpoints as the JAX GUI's, in backend and
standalone mode; its standalone ``/segment``, on the shipped tiny
checkpoint with a config that computes in float32, answers the JAX GUI's
tables for a WAV and a FLAC upload, 400 and an empty table for audio it
cannot read, and 500 for a fault of the segmenter. Neither the GUI nor the
viewer runs on the CPU unless asked to.
"""

import json
import os
import re
import urllib.error
import urllib.request

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from whisperseg_tpu.audio.frontend import Frontend as JaxFrontend  # noqa: E402
from whisperseg_tpu.audio.viewer import SpecViewer as JaxSpecViewer  # noqa: E402
from whisperseg_tpu.audio.viewer import \
    slice_audio_and_label as jax_slice  # noqa: E402
from whisperseg_tpu.segmenter import Segmenter as JaxSegmenter  # noqa: E402
from whisperseg_tpu.services import gui as jgui  # noqa: E402
from whisperseg_torch.audio.frontend import Frontend  # noqa: E402
from whisperseg_torch.audio.viewer import (SpecViewer,  # noqa: E402
                                           slice_audio_and_label)
from whisperseg_torch.segmenter import Segmenter  # noqa: E402
from whisperseg_torch.services import gui  # noqa: E402
from whisperseg_torch.synthetic import audio_bytes, tone_bursts  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
SR = 32000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port on one CPU thread while this module runs (the suite runs
    several processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ viewer


@pytest.mark.parametrize("sr,offset,tracks", [(16000, 0.0, True),
                                              (32000, 0.25, False)])
def test_spec_viewer_image_matches_jax(sr, offset, tracks):
    audio = tone_bursts(3, sr=sr, duration=1.0)
    pred = {"onset": [0.2, 0.5], "offset": [0.3, 0.7], "cluster": ["a", "b"]}
    label = {"onset": [0.2, 0.6], "offset": [0.35, 0.62],
             "cluster": ["a", "a"]}
    strips = None
    if tracks:
        strips = {"vocal": np.linspace(0, 1, 50), "onset": np.zeros(50),
                  "offset": np.full(50, 0.5), "quantum": 0.02}
    window = 0.75
    port, jax_viewer = SpecViewer(device="cpu"), JaxSpecViewer()
    figs = []
    for viewer, frontend in ((port, Frontend), (jax_viewer, JaxFrontend)):
        figs.append(viewer.render(offset, window, audio, pred, label, sr,
                                  "a.wav", frontend(sr, window / 1000, 0),
                                  tracks=strips))
    got, want = (np.asarray(f.axes[0].images[0].get_array()) for f in figs)
    assert got.shape == want.shape
    # bars and strips below the spectrogram's 80 rows
    np.testing.assert_allclose(got[80:], want[80:], rtol=0, atol=1e-4)
    # the spectrogram's colours: the colormap is a table of 256 colours, so
    # a value within 1e-4 of JAX's (below) can land in the next entry
    lut = port.cmap(np.linspace(0, 1, port.cmap.N))[:, :3]
    step = np.abs(np.diff(lut, axis=0)).max()
    off = np.abs(got[:80] - want[:80]).max(axis=-1)
    assert off.max() <= step + 1e-6 and (off > 1e-4).mean() < 1e-3
    assert [t.get_text() for t in figs[0].axes[0].get_xticklabels()] == \
        [t.get_text() for t in figs[1].axes[0].get_xticklabels()]
    # the spectrogram itself, from the port's batched frontend, and the
    # colormap's input
    chunk = audio[int(offset * sr):int((offset + window) * sr)]
    spec = port.spectrogram(Frontend(sr, window / 1000, 0), chunk)
    jspec = JaxFrontend(sr, window / 1000, 0).log_mel_numpy(chunk)
    np.testing.assert_allclose(spec, jspec, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.min_max_norm(spec),
                               JaxSpecViewer.min_max_norm(jspec), rtol=0,
                               atol=1e-4)


def test_spec_viewer_save_and_slicing(tmp_path):
    audio = tone_bursts(4, sr=16000, duration=1.0)
    out = SpecViewer(device="cpu").save(
        str(tmp_path / "v.png"), audio, 16000, window_size=1.0,
        prediction={"onset": [0.2], "offset": [0.4], "cluster": [3]})
    assert os.path.getsize(out) > 1000
    label = {"onset": [0.1, 0.5, 0.9], "offset": [0.3, 0.7, 0.95],
             "cluster": ["a", "b", "c"]}
    for start, end in ((0.0, 1.0), (0.2, 0.6), (0.6, 2.0)):
        sliced, table = slice_audio_and_label(audio, label, 16000, start, end)
        jsliced, jtable = jax_slice(audio, label, 16000, start, end)
        np.testing.assert_array_equal(sliced, jsliced)
        assert table == jtable
        assert SpecViewer.chunk_label(label, start, end) == \
            JaxSpecViewer.chunk_label(label, start, end)


def test_viewer_and_gui_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        SpecViewer()
    with pytest.raises(RuntimeError, match="no CUDA"):
        gui.main(["--model_path", TINY])


# --------------------------------------------------------------------- GUI


def _get(port, path="/"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as resp:
        return resp.headers["Content-Type"], resp.read().decode()


def _post(port, fields, files):
    boundary = "b0undary"
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="{k}"\r\n\r\n{v}\r\n'.encode() for k, v in fields.items()]
    for k, (filename, payload) in files.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f'name="{k}"; filename="{filename}"\r\n\r\n'.encode()
                     + payload + b"\r\n")
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/segment",
        data=b"".join(parts) + f"--{boundary}--\r\n".encode(), method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(app):
    return app.serve("127.0.0.1", 0, background=True).server_address[1]


def _elements(page):
    """The page's element ids, the endpoints it calls and the backend
    address it was given."""
    return (re.findall(r'id="([^"]+)"', page),
            sorted(set(re.findall(r'api\("(/[^"]+)"\)', page))),
            re.findall(r'const BACKEND = "([^"]*)"', page))


@pytest.fixture(scope="module")
def standalone(tmp_path_factory):
    """Both GUIs in standalone mode on the float32 tiny checkpoint."""
    folder = str(tmp_path_factory.mktemp("tiny_f32"))
    os.symlink(os.path.join(TINY, "params.npz"),
               os.path.join(folder, "params.npz"))
    with open(os.path.join(TINY, "config.json")) as f:
        config = json.load(f)
    config["compute_dtype"] = "float32"
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(config, f)
    seg = Segmenter.from_pretrained(folder, inference_dtype="float32",
                                    device="cpu")
    apps = [gui.build_app(segmenter=seg, batch_size=4),
            jgui.build_app(segmenter=JaxSegmenter.from_pretrained(
                folder, inference_dtype="float32"), batch_size=4)]
    ports = [_serve(app) for app in apps]
    yield seg, ports[0], ports[1]
    for app in apps:
        app.shutdown()


def test_pages_hold_the_jax_gui_elements(standalone):
    _, port, jport = standalone
    backend_apps = [m.build_app("127.0.0.1:8060") for m in (gui, jgui)]
    backend_ports = [_serve(app) for app in backend_apps]
    try:
        for got_port, want_port, address in ((port, jport, ""),
                                             (*backend_ports, "127.0.0.1:8060")):
            ctype, page = _get(got_port)
            jctype, jpage = _get(want_port)
            assert ctype == jctype == "text/html; charset=utf-8"
            assert _elements(page) == _elements(jpage)
            assert _elements(page)[2] == [address]
            assert "<title>WhisperSeg</title>" in page
            assert "/segment" in _elements(page)[1]
    finally:
        for app in backend_apps:
            app.shutdown()


def test_standalone_segment_equals_the_jax_gui(standalone, monkeypatch):
    seg, port, jport = standalone
    audio = tone_bursts(20, duration=1.0)
    empty = {"onset": [], "offset": [], "cluster": []}
    for fields in ({"num_trials": 1}, {"frame_mode": 1}):
        want = _post(jport, fields, {"audio_file": (
            "a.wav", audio_bytes(audio, SR, "wav"))})
        assert want[0] == 200
        for fmt in ("wav", "flac"):
            assert _post(port, fields, {"audio_file": (
                f"a.{fmt}", audio_bytes(audio, SR, fmt))}) == want
    assert len(want[1]["onset"]) >= 1
    garbage = {"audio_file": ("a.bin", b"\x00" * 64)}
    assert _post(port, {}, garbage) == _post(jport, {}, garbage) == (400, empty)

    def fault(*args, **kwargs):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(seg, "segment", fault)
    status, answer = _post(port, {"num_trials": 1}, {"audio_file": (
        "a.wav", audio_bytes(audio, SR))})
    assert status == 500 and "kernel launch failed" in answer["error"]
