"""The serving path of the port: the continuous batcher
(``whisperseg_torch/services/batching.py``) and the HTTP segment service
(``services/segment_service.py``), on the shipped tiny checkpoint at float32
on the CPU.

The batcher gives each of several concurrent requests the table a plain
``Segmenter`` gives it, fuses their windows into shared device batches,
hands an error to every waiter of the failing group, and releases a request
whose windows are done before its group ends. The service, served on an
ephemeral port and driven with ``urllib``, answers seq2seq, frame-mode,
``top_p`` and Adobe requests with 201 and the port's own tables, a seq2seq
request with the JAX package's service's answer, a broken body or a bad
option with an empty prediction, and a wrapper's refusal with a 500. Its
``main`` and the CLI's need CUDA unless given ``--device cpu``; ``hub.py``
resolves local, built-in and cached model names.
"""

import base64
import hashlib
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from whisperseg_tpu.checkpoint import load_checkpoint as jax_load
from whisperseg_tpu.segmenter import Segmenter as JaxSegmenter
from whisperseg_tpu.services.segment_service import build_app as jax_build_app
from whisperseg_torch import hub
from whisperseg_torch.audio import frontend
from whisperseg_torch.audio.io import save_wav
from whisperseg_torch.checkpoint import load_checkpoint
from whisperseg_torch.cli import segment as cli
from whisperseg_torch.parallel import make_mesh
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.services import segment_service
from whisperseg_torch.services.batching import BatchingSegmenter
from whisperseg_torch.services.http_util import JsonHTTPServer
from whisperseg_torch.synthetic import tone_bursts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
SR = 32000


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


def _tiny():
    params, cfg = load_checkpoint(TINY)
    cfg.compute_dtype = "float32"
    return params, cfg


@pytest.fixture(scope="module")
def plain():
    params, cfg = _tiny()
    return Segmenter(params, cfg, inference_dtype="float32", device="cpu")


@pytest.fixture(scope="module")
def batched():
    params, cfg = _tiny()
    seg = BatchingSegmenter(params, cfg, inference_dtype="float32",
                            device="cpu", max_batch_size=8, max_wait_ms=50)
    yield seg
    seg.close()


def _spy(monkeypatch, seg, delay=0.0):
    """Record the row count of every device batch ``seg`` runs."""
    rows = []
    inner = seg._decode_batch

    def spy(chunk, *args, **kwargs):
        rows.append(chunk.shape[0])
        time.sleep(delay)
        return inner(chunk, *args, **kwargs)
    monkeypatch.setattr(seg, "_decode_batch", spy)
    return rows


def _concurrently(fns):
    results = [None] * len(fns)

    def run(i):
        results[i] = fns[i]()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results


# -------------------------------------------------------------------- batcher


@pytest.mark.parametrize("frames", [False, True], ids=["tokens", "frames"])
def test_concurrent_requests_fuse_and_match_plain(plain, batched, monkeypatch,
                                                  frames):
    """Three concurrent requests of 1-2 windows share device batches and each
    gets the plain Segmenter's table; ``frames`` keeps the checkpoint's frame
    post-processing on, so the requests need the frame head's tracks: then,
    as in the JAX batcher, none is fused (each runs its own batch on its
    caller's thread) and each still gets the plain table."""
    kw = dict(num_beams=1, batch_size=4)  # the batcher's smallest bucket
    if not frames:
        kw.update(frame_split=0, frame_refine_ms=0, frame_filter=0)
    audios = [tone_bursts(60 + i, duration=2.5 + 2.0 * (i % 2))
              for i in range(3)]
    want = [plain.segment(a, SR, **kw) for a in audios]
    rows = _spy(monkeypatch, batched)
    before = batched.fused_batches
    got = _concurrently([lambda a=a: batched.segment(a, SR, **kw)
                         for a in audios])
    assert got == want
    assert sum(len(w["onset"]) for w in want) >= 9
    if frames:
        assert batched.fused_batches == before
        assert rows == [4, 4, 4], rows  # one batch of batch_size a request
        return
    assert len(rows) < 3, rows  # 4 windows in fewer device batches
    assert batched.fused_batches - before == len(rows)
    assert all(r in (4, 8) for r in rows)  # power-of-two buckets


def test_bucket_sizes(batched):
    assert [batched._bucket(n) for n in (1, 4, 5, 8, 9, 40)] == \
        [4, 4, 8, 8, 8, 8]


def test_error_reaches_every_waiter_and_the_worker_lives(batched, monkeypatch):
    def broken(chunk, *args, **kwargs):
        time.sleep(0.1)
        raise RuntimeError("device batch failed")
    monkeypatch.setattr(batched, "_decode_batch", broken)
    audio = tone_bursts(70, duration=2.5)

    def request():
        try:
            batched.segment(audio, SR, num_beams=1)
        except RuntimeError as e:
            return str(e)
    assert _concurrently([request] * 3) == ["device batch failed"] * 3
    monkeypatch.undo()
    assert batched.segment(audio, SR, num_beams=1)["onset"]


def test_early_release_before_the_group_ends(monkeypatch):
    """Two 3-window requests fused into one group of two device batches of
    4: the first request returns while the second batch is still running.
    Request 1 starts once request 0's windows are queued, so request 0 heads
    the group and its windows fill the first batch. The checkpoint's frame
    post-processing is off: requests that need the frame tracks are not
    fused."""
    params, cfg = _tiny()
    seg = BatchingSegmenter(params, cfg, inference_dtype="float32",
                            device="cpu", max_batch_size=4, max_wait_ms=2000)
    rows = _spy(monkeypatch, seg, delay=0.5)
    queued, groups = threading.Event(), []
    put, decode_group = seg._queue.put, seg._decode_group

    def put_and_tell(item, *args, **kwargs):
        put(item, *args, **kwargs)
        queued.set()

    def record_group(group):
        groups.append(len(group))
        decode_group(group)
    monkeypatch.setattr(seg._queue, "put", put_and_tell)
    monkeypatch.setattr(seg, "_decode_group", record_group)
    audios = [tone_bursts(80 + i, duration=7.5) for i in range(2)]
    done_at = [None, None]

    def request(i):
        if i == 1:
            assert queued.wait(60)
        seg.segment(audios[i], SR, num_beams=1, frame_split=0,
                    frame_refine_ms=0, frame_filter=0)
        done_at[i] = time.monotonic()
    _concurrently([lambda: request(0), lambda: request(1)])
    seg.close()
    assert groups == [2]  # one fused group
    assert rows == [4, 4]
    assert done_at[1] - done_at[0] > 0.3


def test_close_stops_the_worker():
    params, cfg = _tiny()
    seg = BatchingSegmenter(params, cfg, inference_dtype="float32",
                            device="cpu")
    seg.close()
    assert not seg._worker.is_alive()
    seg.close()
    with pytest.raises(RuntimeError, match="closed"):
        seg.segment(tone_bursts(71, duration=2.5), SR, num_beams=1)


def test_a_mesh_is_refused(plain):
    """A mesh is accepted now: its buckets round up to the mesh's device
    count, and fused requests give the plain batcher's tables."""
    params, cfg = _tiny()
    cpu = torch.device("cpu")
    seg = BatchingSegmenter(params, cfg, inference_dtype="float32",
                            mesh=make_mesh(devices=[cpu] * 2), min_bucket=1,
                            max_batch_size=8)
    try:
        assert seg.device == cpu and seg.mesh.size == 2
        assert [seg._bucket(n) for n in (1, 2, 3, 5)] == [2, 2, 4, 8]
        audio = tone_bursts(71, duration=2.5)
        kw = dict(num_beams=1, num_trials=1, frame_split=0, frame_refine_ms=0,
                  frame_filter=0)
        assert seg.segment(audio, SR, **kw) == plain.segment(audio, SR, **kw)
        assert seg.fused_batches == 1
    finally:
        seg.close()
    with pytest.raises(ValueError, match="not both"):
        BatchingSegmenter(params, cfg, device="cpu",
                          mesh=make_mesh(devices=[cpu]))


# -------------------------------------------------------------------- service


def _wav_b64(audio) -> str:
    buf = io.BytesIO()
    save_wav(buf, audio, SR)
    return base64.b64encode(buf.getvalue()).decode()


def _serve(app):
    httpd = app.serve("127.0.0.1", 0, background=True)
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + "/segment", data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def service(batched):
    app = segment_service.build_app(batched, batch_size=4, serialize=False)
    yield _serve(app)
    app.shutdown()


def _roundtrip(table):
    return json.loads(json.dumps(table))


def test_service_answers_concurrent_requests_with_segment_tables(plain,
                                                                 service):
    audio = tone_bursts(90, duration=2.5)
    body = {"audio_file_base64_string": _wav_b64(audio), "sr": SR}
    # the audio as the service reads it back from 16-bit PCM
    heard = np.round(audio * 32767).clip(-32768, 32767) / 32768.0
    heard = heard.astype(np.float32)
    table = plain.segment(heard, SR, num_trials=1, batch_size=4)
    cases = [
        (dict(num_trials=1), table),
        (dict(num_trials=1, num_beams=1, top_p=0.9),
         # alone in its group (sampled with its own seed), one window in a
         # bucket of 4 rows: the plain call with 4-row batches draws alike
         plain.segment(heard, SR, num_trials=1, num_beams=1, top_p=0.9,
                       batch_size=4)),
        (dict(frame_mode=True), plain.segment_from_frames(heard, SR,
                                                          batch_size=4)),
        (dict(num_trials=1, adobe_audition_compatible=True),
         segment_service.adobe_audition_format(table)),
    ]
    answers = _concurrently([lambda kw=kw: _post(service, {**body, **kw})
                             for kw, _ in cases])
    for (kw, want), (status, got) in zip(cases, answers):
        assert status == 201, kw
        assert got == _roundtrip(want), kw
    assert len(table["onset"]) >= 3
    assert list(answers[3][1])[:2] == ["﻿Name", "Start"]


def test_service_answer_equals_the_jax_service(service):
    jparams, jcfg = jax_load(TINY)
    jcfg.compute_dtype = "float32"
    app = jax_build_app(JaxSegmenter(jparams, jcfg, inference_dtype="float32"),
                        batch_size=4)
    jax_url = _serve(app)
    try:
        # the service's default num_trials=3: consolidation, and its
        # low-agreement warning where the trials disagree
        body = {"audio_file_base64_string": _wav_b64(
            tone_bursts(91, duration=4.0)), "sr": SR, "num_beams": 1}
        want = _post(jax_url, body)
        assert _post(service, body) == want
        assert want[0] == 201 and set(want[1]) >= {"onset", "offset",
                                                   "cluster"}
    finally:
        app.shutdown()


QUIET = {"audio_file_base64_string": _wav_b64(np.zeros(8000, np.float32)),
         "sr": SR}


@pytest.mark.parametrize("body", [
    b"not json",
    {"audio_file_base64_string": "!!!", "sr": SR},
    {"sr": SR},
    {"audio_file_base64_string": base64.b64encode(b"fLaC" + bytes(40)).decode(),
     "sr": SR},
    {**QUIET, "num_trials": "three"},
    {**QUIET, "num_beams": 0},
    {**QUIET, "max_length": 10 ** 6},
    {**QUIET, "top_p": 1.5},
    {**QUIET, "eps": -1.0},
    {**QUIET, "merge_gap_ms": "wide"},
], ids=["not_json", "bad_base64", "no_audio", "flac", "bad_option",
        "no_beams", "max_length_past_the_decoder", "top_p_above_1",
        "negative_eps", "text_merge_gap"])
def test_broken_request_gets_an_empty_prediction(service, body):
    assert _post(service, body) == (201, {"onset": [], "offset": [],
                                          "cluster": []})


@pytest.mark.parametrize("options", [dict(num_trials=1, num_beams=1),
                                     dict(frame_mode=True)],
                         ids=["seq2seq", "frame_mode"])
def test_a_refused_kernel_launch_answers_500(service, monkeypatch, options):
    """The kernel wrappers refuse input they cannot launch on with a
    ValueError: the service answers 500, not an empty table."""
    def refuse(*args, **kwargs):
        raise ValueError("melproject_reim: no kernel for these shapes")
    monkeypatch.setattr(frontend, "melproject_reim", refuse)
    body = {"audio_file_base64_string": _wav_b64(tone_bursts(92, duration=2.5)),
            "sr": SR, **options}
    status, answer = _post(service, body)
    assert status == 500
    assert answer == {"error": "ValueError: melproject_reim: no kernel for "
                               "these shapes"}


def test_status(service):
    with urllib.request.urlopen(service + "/status", timeout=30) as resp:
        assert resp.status == 200
        assert json.loads(resp.read()) == {"status": "ready"}


# --------------------------------------------------------------- entry points


def test_download_model_resolves_local_builtin_and_cached(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("WHISPERSEG_MODEL_CACHE", str(tmp_path / "cache"))
    assert hub.download_model(TINY) == TINY
    assert hub.download_model("whisperseg-tiny-animal-vad") == \
        hub.builtin_models()["whisperseg-tiny-animal-vad"]
    assert os.path.samefile(hub.builtin_models()["whisperseg-tiny-animal-vad"],
                            TINY)
    cached = tmp_path / "cache" / hashlib.sha256(b"lab/finch-model").hexdigest()
    with pytest.raises(NotImplementedError, match="not part of the port"):
        hub.download_model("lab/finch-model")
    cached.mkdir(parents=True)
    (cached / "config.json").write_text("{}")
    assert hub.download_model("lab/finch-model") == str(cached)



def test_entry_points_need_cuda_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        segment_service.main(["--model_path", TINY])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--model_path", TINY, "--audio_path", "x.wav",
                  "--csv_save_path", str(tmp_path / "a.csv")])


def test_main_warms_up_and_serves_on_the_cpu(monkeypatch):
    served = {}

    def serve(self, host, port, background=False):
        served.update(host=host, port=port, routes=set(self.routes))
    monkeypatch.setattr(JsonHTTPServer, "serve", serve)
    warmed = []
    inner = BatchingSegmenter.warmup

    def warmup(self, *args, **kwargs):
        inner(self, *args, **kwargs)
        warmed.append(self.fused_batches)
    monkeypatch.setattr(BatchingSegmenter, "warmup", warmup)
    segment_service.main(["--model_path", "whisperseg-tiny-animal-vad",
                          "--device", "cpu", "--continuous_batching", "1",
                          "--batch_size", "4", "--port", "8123"])
    assert served == {"host": "0.0.0.0", "port": 8123,
                      "routes": {("POST", "/segment"), ("GET", "/status")}}
    assert warmed == [1]  # one fused batch of the default configuration
