"""The port's model-zoo backend (``whisperseg_torch/services/backend.py``),
its client (``services/client.py``), the marmoset post-processing
(``services/post_process.py``) and the offline fitters of
``refine.py`` (``fit_postprocess``, ``fit_frame_mode``), against the JAX
package, on the CPU.

Both backends serve the shipped tiny checkpoint with a config that computes
in float32, on ephemeral ports: their list endpoints give the same answers,
and ``/segment`` with a WAV and a FLAC of one 1 s clip gives the JAX
backend's table. A request the port's backend cannot serve (no audio, an
unknown model, audio that cannot be decoded) gets the JAX backend's empty
table and 400; a fault of the segmenter answers 500. The training queue
runs end to end: a zip of FLAC clips with CSV labels, submitted through the
client, trains a small random model in a subprocess (a shim around the
port's train CLI with an iteration cap, given ``--device cpu`` by the
backend), which then segments.
"""

import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from whisperseg_tpu import refine as jrefine
from whisperseg_tpu.services import PROCESS_TOOLBOX as JAX_TOOLBOX
from whisperseg_tpu.services.backend import BackendState as JaxBackendState
from whisperseg_tpu.services.backend import build_app as jax_build_app
from whisperseg_torch import refine
from whisperseg_torch.checkpoint import load_checkpoint, save_checkpoint
from whisperseg_torch.models import WhisperConfig
from whisperseg_torch.models.whisper import init_params
from whisperseg_torch.services import PROCESS_TOOLBOX, client
from whisperseg_torch.services.backend import BackendState, build_app
from whisperseg_torch.services.segment_service import \
    build_app as service_build_app
from whisperseg_torch.synthetic import (audio_bytes, tone_bursts,
                                        tone_dataset_zip)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
MODEL = "tiny-f32"
SR = 32000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port on one CPU thread while this module runs (the suite runs
    several processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32_checkpoint(folder):
    """The tiny checkpoint with a config that computes in float32 (the
    weights file linked)."""
    os.makedirs(folder)
    os.symlink(os.path.join(TINY, "params.npz"),
               os.path.join(folder, "params.npz"))
    with open(os.path.join(TINY, "config.json")) as f:
        config = json.load(f)
    config["compute_dtype"] = "float32"
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(config, f)
    return folder


def _serve(app):
    return app.serve("127.0.0.1", 0, background=True).server_address[1]


def _wait(condition, seconds=60):
    """Poll ``condition`` until it holds or ``seconds`` pass."""
    deadline = time.time() + seconds
    while not condition() and time.time() < deadline:
        time.sleep(0.05)
    assert condition()


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    """(port state, its port, JAX state, its port); each backend has the
    float32 tiny checkpoint as a built-in model and one fine-tuned-like
    model in its model folder, and lists them once a second."""
    root = tmp_path_factory.mktemp("backends")
    path = _f32_checkpoint(str(root / MODEL))
    pretrained = [{"model_name": MODEL, "inference_model_path": path,
                   "finetune_model_path": path}]
    # the training subprocess on one torch thread, as this module: the suite
    # runs several processes at once, and a pool of one thread per core in
    # each of them slows every one down many times over
    shim = root / "train_capped.py"
    shim.write_text(
        "import sys\n"
        "import torch\n"
        "from whisperseg_torch.cli.train import main\n"
        "torch.set_num_threads(1)\n"
        "main(sys.argv[1:] + ['--min_num_iterations', '10',\n"
        "                     '--print_every', '10', '--num_workers', '0'])\n")
    states, ports, apps = [], [], []
    for cls, build, name in ((BackendState, build_app, "port"),
                             (JaxBackendState, jax_build_app, "jax")):
        kwargs = dict(pretrained_models=pretrained, inference_dtype="float32")
        if name == "port":
            kwargs.update(device="cpu", train_script=str(shim))
        state = cls(str(root / name / "datasets"), str(root / name / "models"),
                    **kwargs)
        _f32_checkpoint(str(root / name / "models" / "zebra" /
                            "final_checkpoint"))
        threading.Thread(target=state.periodic_list_models,
                         daemon=True).start()
        app = build(state)
        states.append(state)
        ports.append(_serve(app))
        apps.append(app)
    threading.Thread(target=states[0].run_training_worker, daemon=True).start()
    for state in states:  # the first refresh
        _wait(lambda: len(state.model_information["all_models"]) >= 2)
    yield states[0], ports[0], states[1], ports[1]
    for app in apps:
        app.shutdown()


def _post(port, path, fields=None, files=None):
    """POST multipart form data -> (status, JSON answer)."""
    boundary = "boundary1234"
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in (fields or {}).items()]
    for k, (filename, payload) in (files or {}).items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f'name="{k}"; filename="{filename}"\r\n\r\n'.encode()
                     + payload + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -------------------------------------------------------------- endpoints


def test_list_endpoints_equal_jax(backends):
    state, port, _, jport = backends
    for path in ("/list-models-available-for-finetuning",
                 "/list-models-available-for-inference",
                 "/list-models-training-in-progress", "/list-all-models",
                 "/get-training-request-queue"):
        got, want = _post(port, path), _post(jport, path)
        assert got == want, path
    names = [m["model_name"] for m in
             _post(port, "/list-models-available-for-inference")[1]["response"]]
    assert names[:2] == [MODEL, "zebra"]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/status") as resp:
        assert json.loads(resp.read()) == {"status": "ready"}


def test_segment_wav_and_flac_equal_the_jax_backend(backends):
    _, port, _, jport = backends
    audio = tone_bursts(40, duration=1.0)
    fields = {"model_name": MODEL, "num_trials": 1}
    tables = {}
    for fmt in ("wav", "flac"):
        status, tables[fmt] = _post(port, "/segment", fields, {
            "audio_file": (f"a.{fmt}", audio_bytes(audio, SR, fmt))})
        assert status == 200, tables[fmt]
    status, want = _post(jport, "/segment", fields, {
        "audio_file": ("a.wav", audio_bytes(audio, SR, "wav"))})
    assert status == 200
    assert tables["wav"] == tables["flac"] == want
    assert len(want["onset"]) >= 2
    # frame mode, and a fine-tuned-like model of the model folder
    fields = {"model_name": "zebra", "frame_mode": 1}
    flac = {"audio_file": ("a.flac", audio_bytes(audio, SR, "flac"))}
    assert _post(port, "/segment", fields, flac) == \
        _post(jport, "/segment", fields, flac)


def test_bad_requests_get_400_and_a_segmenter_fault_500(backends,
                                                        monkeypatch):
    state, port, _, jport = backends
    wav = {"audio_file": ("a.wav", audio_bytes(tone_bursts(41, duration=0.5),
                                               SR))}
    empty = {"onset": [], "offset": [], "cluster": []}
    for fields, files in (({"model_name": MODEL}, None),
                          ({"model_name": "no-such-model"}, wav),
                          ({"model_name": MODEL},
                           {"audio_file": ("a.flac", b"fLaC" + bytes(60))}),
                          ({"model_name": MODEL},
                           {"audio_file": ("a.bin", b"\x00" * 100)})):
        assert _post(port, "/segment", fields, files) == (400, empty)
        assert _post(jport, "/segment", fields, files) == (400, empty)

    seg = state.get_segmenter(MODEL, state.pretrained_models[0][
        "inference_model_path"])

    def fault(*args, **kwargs):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(seg, "segment", fault)
    status, answer = _post(port, "/segment", {"model_name": MODEL}, wav)
    assert status == 500 and "kernel launch failed" in answer["error"]


def test_client_against_the_backend_and_the_segment_service(backends,
                                                            tmp_path):
    state, port, _, _ = backends
    path = str(tmp_path / "a.flac")
    with open(path, "wb") as f:
        f.write(audio_bytes(tone_bursts(42, duration=1.0), SR, "flac"))
    with open(path, "rb") as f:
        files = {"audio_file": ("a.flac", f.read())}
    want = _post(port, "/segment", {"model_name": MODEL, "num_trials": 1},
                 files)[1]
    assert client.segment(f"127.0.0.1:{port}", path, MODEL) == want
    assert client.segment(f"127.0.0.1:{port}", path, "no-such-model") == \
        {"onset": [], "offset": [], "cluster": []}
    seg = state.get_segmenter(MODEL, state.pretrained_models[0][
        "inference_model_path"])
    app = service_build_app(seg, batch_size=4)
    try:
        got = client.segment_base64(f"127.0.0.1:{_serve(app)}", path, SR,
                                    num_trials=1)
    finally:
        app.shutdown()
    assert got == want


def test_training_command(tmp_path):
    req = {"model_name": "m", "train_dataset_folder": "/d", "num_epochs": 2,
           "ignore_cluster": 1}
    tail = ["--initial_model_path", "/init", "--train_dataset_folder", "/d/",
            "--model_folder", str(tmp_path / "models" / "m"),
            "--max_num_epochs", "2", "--ignore_cluster", "1",
            "--frame_head", "1"]
    state = BackendState(str(tmp_path / "d"), str(tmp_path / "models"),
                         device="cpu")
    assert state.training_command("/init", req) == \
        [sys.executable, "-m", "whisperseg_torch.cli.train", *tail,
         "--device", "cpu"]
    state.train_script, state.train_device = "t.py", None
    assert state.training_command("/init", req) == [sys.executable, "t.py",
                                                    *tail]


def test_training_queue_end_to_end(backends, tmp_path):
    """A zip of three FLAC clips with CSV labels, submitted through the
    client, trains a small random model in a subprocess on the CPU; the
    model is then listed ready and segments."""
    state, port, _, _ = backends
    cfg = WhisperConfig(d_model=128, encoder_layers=2, decoder_layers=2,
                        num_heads=2, d_ff=256, max_source_positions=50,
                        max_target_positions=48, total_spec_columns=100,
                        compute_dtype="float32")
    save_checkpoint(os.path.join(state.model_base_folder, "base-model",
                                 "final_checkpoint"),
                    init_params(torch.Generator().manual_seed(0), cfg), cfg)
    folder = str(tmp_path / "upload")
    with zipfile.ZipFile(io.BytesIO(tone_dataset_zip(
            3, seed=50, sr=16000, duration=1.0))) as zf:
        zf.extractall(folder)
    _wait(lambda: "base-model" in [m["model_name"] for m in
                                   state.model_information["all_models"]])
    assert client.train(f"127.0.0.1:{port}", folder, "queued-model",
                        initial_model_name="base-model", num_epochs=1) == \
        {"message": "Training"}
    queue = _post(port, "/get-training-request-queue")[1]["response"]
    assert [q["model_name"] for q in queue] == ["queued-model"]

    deadline = time.time() + 240
    ready = []
    while time.time() < deadline and "queued-model" not in ready and \
            not any(e["exit_code"] for e in state.training_log):
        time.sleep(0.5)
        ready = [m["model_name"] for m in _post(
            port, "/list-models-available-for-inference")[1]["response"]]
    assert state.training_log and state.training_log[-1]["exit_code"] == 0, \
        state.training_log
    assert "queued-model" in ready
    final = os.path.join(state.model_base_folder, "queued-model",
                         "final_checkpoint")
    params, trained = load_checkpoint(final)
    assert trained.frame_head and "frame_head" in params
    assert trained.current_step == 10
    status, answer = _post(port, "/segment", {
        "model_name": "queued-model", "num_trials": 1}, {
        "audio_file": ("a.flac", audio_bytes(np.zeros(16000), 16000, "flac"))})
    assert status == 200 and set(answer) == {"onset", "offset", "cluster"}


# -------------------------------------------------------- post-processing


def test_marmoset_rules_equal_jax():
    rng = np.random.RandomState(0)
    name = "whisperseg-large-marmoset-v2.0"
    assert set(PROCESS_TOOLBOX) == set(JAX_TOOLBOX) == {name}
    for _ in range(200):
        n = rng.randint(0, 20)
        onsets = np.cumsum(rng.uniform(0.0, 0.05, n)).round(3)
        offsets = (onsets + rng.uniform(0.001, 0.02, n)).round(3)
        clusters = rng.choice(["e_ts", "e_tw", "e_p1", "x"], n,
                              p=[0.6, 0.1, 0.15, 0.15]).tolist()
        table = {"onset": onsets.tolist(), "offset": offsets.tolist(),
                 "cluster": clusters}
        assert PROCESS_TOOLBOX[name](dict(table)) == \
            JAX_TOOLBOX[name](dict(table))


def _fit_inputs(seed):
    """Tone-burst audio, its labels, predictions that merge and shift some
    of the bursts, and frame tracks with noise on the truth."""
    rng = np.random.RandomState(seed)
    audios, labels, preds, tracks, deltas = [], [], [], [], []
    for i in range(2):
        y, on, off = tone_bursts(seed + i, sr=16000, duration=1.0,
                                 with_segments=True)
        audios.append(y)
        labels.append({"onset": on, "offset": off, "cluster": ["v"] * len(on),
                       "tolerance": 0.01, "spec_time_step": 0.0025})
        p_on, p_off = [on[0]], []
        for k in range(1, len(on)):
            if rng.rand() < 0.4:
                continue  # merged with the previous burst
            p_off.append(off[k - 1])
            p_on.append(on[k] + rng.uniform(-0.01, 0.01))
        p_off.append(off[-1])
        preds.append({"onset": p_on, "offset": p_off,
                      "cluster": ["v"] * len(p_on)})
        q, T = 0.005, 200
        t = np.arange(T) * q
        vocal = np.zeros(T, np.float32)
        for a, b in zip(on, off):
            vocal[(t >= a) & (t < b)] = 0.8
        vocal = np.clip(vocal + 0.1 * rng.rand(T), 0, 1).astype(np.float32)
        edges = np.abs(np.diff(vocal, prepend=0)).astype(np.float32)
        tracks.append({"vocal": vocal, "onset": edges, "offset": edges[::-1],
                       "cluster": np.zeros(T, np.int32), "quantum": q})
        deltas.append(0.008)
    return audios, labels, preds, tracks, deltas


def test_fit_postprocess_and_fit_frame_mode_equal_jax():
    audios, labels, preds, tracks, deltas = _fit_inputs(60)
    srs = [16000] * len(audios)
    grid = dict(merge_gap_ms=(5.0,), split_db=(10.0, 15.0),
                widths_ms=(20.0,))
    for kwargs in (grid, dict(grid, frame_tracks=tracks, time_deltas=deltas,
                              frame_split=(0.3,), frame_refine_ms=(10.0,),
                              frame_filter=(0.5,))):
        got = refine.fit_postprocess(preds, labels, audios, srs, **kwargs)
        assert got == jrefine.fit_postprocess(preds, labels, audios, srs,
                                              **kwargs)
        assert len(got[1]) > 1
    durations = [1.0] * len(tracks)
    got = refine.fit_frame_mode(tracks, labels, durations, deltas,
                                {0: "Vocal"}, boundary_snap=(2, 4),
                                gap_cut=(0, 4))
    assert got == jrefine.fit_frame_mode(tracks, labels, durations, deltas,
                                         {0: "Vocal"}, boundary_snap=(2, 4),
                                         gap_cut=(0, 4))
    assert len(got[1]) == 4 * 3 * 2 * 2
