"""The port stands alone: no JAX and no ``whisperseg_tpu`` import, no silent
CPU execution, and no kernel launch counted for tensors on the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from whisperseg_torch.audio.frontend import Frontend
from whisperseg_torch.ops import attention, cross_attention, logmel, quant
from whisperseg_torch.segmenter import Segmenter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")


def test_import_and_cpu_segment_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import whisperseg_torch\n"
        "from whisperseg_torch.synthetic import tone_bursts\n"
        f"seg = whisperseg_torch.Segmenter.from_pretrained({TINY!r}, device='cpu')\n"
        "out = seg.segment(tone_bursts(0, duration=2.0), 32000, num_beams=1)\n"
        "assert set(out) == {'onset', 'offset', 'cluster'}, out\n"
        "assert not any(m == 'whisperseg_tpu' or m.startswith('whisperseg_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok', len(out['onset']))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_package_import_anywhere():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "chip_bf16_numerics.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "whisperseg_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    scanned = {os.path.relpath(f, ROOT) for f in files}
    assert {"whisperseg_torch/ops/quant.py", "whisperseg_torch/ops/dot.py",
            "whisperseg_torch/ops/cross_attention.py",
            "whisperseg_torch/training/trainer.py",
            "whisperseg_torch/cli/train.py", "whisperseg_torch/data.py",
            "whisperseg_torch/audio/io.py", "whisperseg_torch/evaluate.py",
            "whisperseg_torch/scoring.py",
            "whisperseg_torch/profiling.py", "whisperseg_torch/hub.py",
            "whisperseg_torch/audio/stream.py",
            "whisperseg_torch/cli/segment.py",
            "whisperseg_torch/services/batching.py",
            "whisperseg_torch/services/http_util.py",
            "whisperseg_torch/services/segment_service.py",
            "whisperseg_torch/services/post_process.py",
            "whisperseg_torch/services/backend.py",
            "whisperseg_torch/services/client.py",
            "whisperseg_torch/services/gui.py",
            "whisperseg_torch/audio/flac.py",
            "whisperseg_torch/audio/formats.py",
            "whisperseg_torch/audio/native.py",
            "whisperseg_torch/audio/mp3_tables.py",
            "whisperseg_torch/audio/mp3_dsp.py",
            "whisperseg_torch/audio/mp3.py",
            "whisperseg_torch/audio/mp3_craft.py",
            "whisperseg_torch/audio/vorbis.py",
            "whisperseg_torch/audio/mpg123.py",
            "whisperseg_torch/audio/opus.py",
            "whisperseg_torch/audio/viewer.py",
            "whisperseg_torch/refine.py",
            "whisperseg_torch/augment.py", "whisperseg_torch/pretrain.py",
            "whisperseg_torch/models/gqa.py",
            "whisperseg_torch/models/convert_hf.py",
            "whisperseg_torch/models/export_hf.py",
            "whisperseg_torch/parallel/__init__.py",
            "whisperseg_torch/parallel/mesh.py",
            "whisperseg_torch/parallel/multihost.py"} <= scanned
    # neither JAX nor the JAX package, nor the packages the chip machine
    # lacks (the JAX package's CLI and services use some of them)
    banned = ("jax", "jaxlib", "whisperseg_tpu", "pandas", "tqdm", "requests",
              "flask")
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, (path, mod)


def test_hf_and_parallel_modules_without_jax(tmp_path):
    """The HF conversion and the parallel layer import, and an HF export of
    the tiny checkpoint reads back through ``from_pretrained``, with JAX
    unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)  # beside other test processes\n"
        "import whisperseg_torch.parallel\n"
        "from whisperseg_torch.parallel import multihost\n"
        "from whisperseg_torch.models import convert_hf, export_hf\n"
        "from whisperseg_torch.checkpoint import load_checkpoint\n"
        "from whisperseg_torch.segmenter import Segmenter\n"
        f"params, cfg = load_checkpoint({TINY!r})\n"
        f"out = export_hf.export_hf_checkpoint(params, cfg, {str(tmp_path)!r})\n"
        "seg = Segmenter.from_pretrained(out, device='cpu')\n"
        "assert seg.config.d_model == cfg.d_model\n"
        "assert not any(m == 'whisperseg_tpu' or m.startswith('whisperseg_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_service_frame_mode_and_cli_without_jax(tmp_path):
    """A CPU service request through the continuous batcher (with the
    checkpoint's frame post-processing off: a request that needs the frame
    tracks runs on its caller's thread), and the segment CLI in frame mode
    over a stream, with JAX and the packages the chip machine lacks
    unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'pandas', 'tqdm', 'requests', 'flask'):\n"
        "    sys.modules[m] = None\n"
        "import base64, io, json, urllib.request\n"
        "import torch; torch.set_num_threads(1)  # beside other test processes\n"
        "from whisperseg_torch.audio.io import save_wav\n"
        "from whisperseg_torch.cli import segment as cli\n"
        "from whisperseg_torch.services.batching import BatchingSegmenter\n"
        "from whisperseg_torch.services.segment_service import build_app\n"
        "from whisperseg_torch.synthetic import tone_bursts\n"
        f"seg = BatchingSegmenter.from_pretrained({TINY!r}, device='cpu')\n"
        "audio = tone_bursts(0, duration=2.5)\n"
        "buf = io.BytesIO(); save_wav(buf, audio, 32000)\n"
        "app = build_app(seg, batch_size=4, serialize=False)\n"
        "httpd = app.serve('127.0.0.1', 0, background=True)\n"
        "body = json.dumps({'audio_file_base64_string':\n"
        "    base64.b64encode(buf.getvalue()).decode(), 'sr': 32000,\n"
        "    'num_trials': 1, 'num_beams': 1, 'frame_split': 0,\n"
        "    'frame_refine_ms': 0, 'frame_filter': 0}).encode()\n"
        "req = urllib.request.Request(\n"
        "    f'http://127.0.0.1:{httpd.server_address[1]}/segment', data=body)\n"
        "with urllib.request.urlopen(req, timeout=120) as resp:\n"
        "    assert resp.status == 201\n"
        "    table = json.loads(resp.read())\n"
        "app.shutdown()\n"
        "seg.close()\n"
        "assert table['onset'] and seg.fused_batches == 1, table\n"
        f"save_wav({str(tmp_path / 'a.wav')!r}, audio, 32000)\n"
        f"cli.main(['--model_path', {TINY!r}, '--device', 'cpu',\n"
        f"          '--audio_path', {str(tmp_path / 'a.wav')!r},\n"
        f"          '--frame_mode', '1', '--streaming', '1',\n"
        f"          '--batch_size', '1',\n"
        f"          '--csv_save_path', {str(tmp_path / 'a.csv')!r}])\n"
        "assert not any(m == 'whisperseg_tpu' or m.startswith('whisperseg_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    with open(tmp_path / "a.csv") as f:
        assert f.readline() == "onset,offset,cluster\n"
        assert f.readline()


def test_backend_client_and_decoders_without_jax(tmp_path):
    """The backend on the CPU answers the client's FLAC upload, and FLAC,
    MP3 and the native library decode, with JAX and the packages the chip
    machine lacks unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'pandas', 'tqdm', 'requests', 'flask'):\n"
        "    sys.modules[m] = None\n"
        "import os\n"
        "import torch; torch.set_num_threads(1)  # beside other test processes\n"
        "from whisperseg_torch.audio import native\n"
        "from whisperseg_torch.audio.io import load_audio\n"
        "from whisperseg_torch.services import client, gui\n"
        "from whisperseg_torch.services.backend import BackendState, build_app\n"
        "from whisperseg_torch.synthetic import audio_bytes, crafted_mp3, tone_bursts\n"
        f"root = {str(tmp_path)!r}\n"
        f"entry = {{'model_name': 'tiny', 'inference_model_path': {TINY!r},\n"
        f"         'finetune_model_path': {TINY!r}}}\n"
        "state = BackendState(os.path.join(root, 'd'), os.path.join(root, 'm'),\n"
        "                     pretrained_models=[entry], device='cpu')\n"
        "state.model_information['all_models'] = state.list_models()\n"
        "app = build_app(state)\n"
        "port = app.serve('127.0.0.1', 0, background=True).server_address[1]\n"
        "path = os.path.join(root, 'a.flac')\n"
        "with open(path, 'wb') as f:\n"
        "    f.write(audio_bytes(tone_bursts(0, duration=1.0), 32000, 'flac'))\n"
        "table = client.segment(f'127.0.0.1:{port}', path, 'tiny')\n"
        "app.shutdown()\n"
        "assert set(table) == {'onset', 'offset', 'cluster'}, table\n"
        "y, sr = load_audio(crafted_mp3(1, duration=1.0))\n"
        "assert sr == 32000 and abs(y).max() > 0\n"
        "assert native.available() and gui.PAGE\n"
        "assert not any(m == 'whisperseg_tpu' or m.startswith('whisperseg_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Segmenter.from_pretrained(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Frontend(32000, 0.0025).features_for_clips(np.zeros((1, 8000)), 100)


def test_cpu_training_without_jax(tmp_path):
    """Two steps of ``run_training(device="cpu")`` from a checkpoint and a
    tone dataset the port writes itself, with JAX unimportable."""
    code = (
        "import os, sys; sys.modules['jax'] = None\n"
        "import torch\n"
        "from whisperseg_torch.checkpoint import save_checkpoint\n"
        "from whisperseg_torch.models.config import WhisperConfig\n"
        "from whisperseg_torch.models.whisper import init_params\n"
        "from whisperseg_torch.synthetic import write_tone_dataset\n"
        "from whisperseg_torch.training import TrainArgs, run_training\n"
        f"root = {str(tmp_path)!r}\n"
        "cfg = WhisperConfig(d_model=128, encoder_layers=1, decoder_layers=1,\n"
        "    num_heads=2, d_ff=256, max_source_positions=100,\n"
        "    max_target_positions=32, total_spec_columns=200,\n"
        "    compute_dtype='float32')\n"
        "save_checkpoint(os.path.join(root, 'init'),\n"
        "                init_params(torch.Generator().manual_seed(0), cfg), cfg)\n"
        "data = write_tone_dataset(os.path.join(root, 'data'), 2, sr=16000,\n"
        "                          duration=2.0, spec_time_step=0.005)\n"
        "final = run_training(TrainArgs(initial_model_path=os.path.join(root, 'init'),\n"
        "    model_folder=os.path.join(root, 'model'), train_dataset_folder=data,\n"
        "    max_num_iterations=2, batch_size=2, max_length=16,\n"
        "    total_spec_columns=200, frame_head=True, print_every=1,\n"
        "    device='cpu'))\n"
        "assert final and os.path.exists(os.path.join(final, 'params.npz'))\n"
        "assert not any(m == 'whisperseg_tpu' or m.startswith('whisperseg_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_wrappers_count_no_launch_on_cpu_tensors():
    logmel.launches = attention.launches = 0
    attention.launches_bwd_dkv = attention.launches_bwd_dq = 0
    Frontend(32000, 0.0025).features_for_clips(
        np.random.RandomState(0).randn(2, 8000).astype(np.float32), 100,
        device="cpu")
    q = torch.zeros(1, 2, 64, 64)
    attention.fused_attention_head_major(64, q, torch.zeros(1, 2, 64, 64),
                                         torch.zeros(1, 2, 64, 64))
    leaves = [torch.randn(1, 2, 64, 64, requires_grad=True) for _ in range(3)]
    attention.encoder_attention(50, *leaves).sum().backward()
    assert logmel.launches == 0 and attention.launches == 0
    assert attention.launches_bwd_dkv == attention.launches_bwd_dq == 0


@pytest.mark.parametrize("inference_dtype", ["int8", "int4"])
def test_quantized_cpu_segment_counts_no_launch(inference_dtype):
    """On ``device="cpu"`` the quantized modes run the plain versions."""
    quant.launches_w8a16 = quant.launches_w4a16 = cross_attention.launches = 0
    seg = Segmenter.from_pretrained(TINY, inference_dtype=inference_dtype,
                                    device="cpu")
    layers = seg.params["decoder"]["layers"]
    assert isinstance(layers["xq_w"], (quant.QuantTensor, quant.Quant4Tensor))
    assert layers["xq_b"].dtype == torch.bfloat16
    assert seg.params["decoder"]["tok_emb"].dtype == torch.bfloat16
    audio = np.random.RandomState(0).randn(16000).astype(np.float32)
    out = seg.segment(audio, 32000, num_beams=1, int8_kv=True)
    assert set(out) == {"onset", "offset", "cluster"}
    assert quant.launches_w8a16 == quant.launches_w4a16 == 0
    assert cross_attention.launches == 0


def test_quantized_entry_points_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for inference_dtype in ("int8", "int4"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Segmenter.from_pretrained(TINY, inference_dtype=inference_dtype)
