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
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "whisperseg_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    scanned = {os.path.relpath(f, ROOT) for f in files}
    assert {"whisperseg_torch/ops/quant.py", "whisperseg_torch/ops/dot.py",
            "whisperseg_torch/ops/cross_attention.py"} <= scanned
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "whisperseg_tpu"), (path, mod)


def test_entry_points_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Segmenter.from_pretrained(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Frontend(32000, 0.0025).features_for_clips(np.zeros((1, 8000)), 100)


def test_wrappers_count_no_launch_on_cpu_tensors():
    logmel.launches = attention.launches = 0
    Frontend(32000, 0.0025).features_for_clips(
        np.random.RandomState(0).randn(2, 8000).astype(np.float32), 100,
        device="cpu")
    q = torch.zeros(1, 2, 64, 64)
    attention.fused_attention_head_major(64, q, torch.zeros(1, 2, 64, 64),
                                         torch.zeros(1, 2, 64, 64))
    assert logmel.launches == 0 and attention.launches == 0


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
