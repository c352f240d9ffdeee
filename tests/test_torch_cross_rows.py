"""The decoder step's cross-attention over head-major K/V at one row a
window (``models/whisper.py::_cross_attention``): a window's K beams as K
queries against its one K/V equal ``_attention`` against the K/V repeated to
a row a beam, MHA and GQA, float32 and bf16; a one-token ``decoder_step``
reads the cross K/V in place, with no copy of it; a beam search counts the
rows its cross K/V holds (``cross_rows``): its windows, or a row a beam on
the int8 route. This file imports no JAX."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from whisperseg_torch import decode
from whisperseg_torch.models import whisper as tw
from whisperseg_torch.models.config import make_config

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_heads", [0, 2])
@pytest.mark.parametrize("beams", [1, 4])
@pytest.mark.parametrize("lq", [1, 3])
def test_beams_as_queries_equal_attention_over_repeated_rows(
        beams, kv_heads, dtype, lq):
    """Bit-equal where the sums run in the same order, else within 1e-6 of
    the largest output (a single query row is a matrix-vector product on
    one side and a matrix product on the other)."""
    cdt = DTYPES[dtype]
    windows, seq, heads, hd = 3, 50, 6, 64
    hk = kv_heads or heads
    gen = torch.Generator().manual_seed(7 * beams + kv_heads)
    q = torch.randn(windows * beams, lq, heads, hd, generator=gen)
    k = torch.randn(windows, hk, seq, hd, generator=gen).to(cdt)
    v = torch.randn(windows, hk, seq, hd, generator=gen).to(cdt)
    got = tw._cross_attention(q, k, v, cdt)
    want = tw._attention(q, k.transpose(1, 2).repeat_interleave(beams, 0),
                         v.transpose(1, 2).repeat_interleave(beams, 0), cdt)
    assert got.shape == want.shape == (windows * beams, lq, heads * hd)
    assert got.dtype == torch.float32
    err = (got - want).abs().max() / want.abs().max()
    assert torch.equal(got, want) or err <= 1e-6, float(err)


def _small(kv_heads: int, dtype: str):
    """A 2 + 2-layer model of the tiny width with 100 encoder positions (a
    size no other axis of its step has) and random weights."""
    cfg = make_config("tiny", total_spec_columns=200, encoder_layers=2,
                      decoder_layers=2, num_kv_heads=kv_heads,
                      compute_dtype=dtype)
    return cfg, tw.init_params(torch.Generator().manual_seed(kv_heads), cfg)


def _copies_over(seq: int, least: int, fn) -> list:
    """The clones and copies ``fn()`` runs over a tensor with an axis of
    ``seq`` and at least ``least`` elements, under a CPU profiler that
    records shapes."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
    return [(e.name, e.input_shapes) for e in p.events()
            if e.name in ("aten::clone", "aten::copy_", "aten::contiguous")
            and any(isinstance(s, list) and seq in s and math.prod(s) >= least
                    for s in e.input_shapes)]


@pytest.mark.parametrize("kv_heads", [0, 2])
def test_a_beam_step_reads_the_cross_kv_in_place(kv_heads, one_thread):
    """A one-token ``decoder_step`` of 2 windows x 4 beams over head-major
    cross K/V at 2 rows makes no clone or copy of a tensor the size of a
    layer's cross K with its 100 positions (the scores, cast for the
    float32 softmax, are smaller); ``_attention`` over the position-major
    layout it replaced makes them (so the profiler sees such copies)."""
    cfg, params = _small(kv_heads, "bfloat16")
    gen = torch.Generator().manual_seed(1)
    enc = torch.randn(2, 100, cfg.d_model, generator=gen)
    seq = enc.shape[1]
    xk, xv = tw.precompute_cross_kv(params, cfg, enc)
    assert xk.shape == (cfg.decoder_layers, 2, cfg.kv_heads, seq,
                        cfg.head_dim)
    ck, cv = tw.init_cache(cfg, 8, 12, "cpu")
    ids = torch.randint(0, cfg.vocab_size, (8, 1), generator=gen)
    least = xk[0].numel()
    assert _copies_over(seq, least, lambda: tw.decoder_step(
        params, cfg, xk, xv, ids, torch.tensor(5), ck, cv)) == []

    q = torch.randn(8, 1, cfg.num_heads, cfg.head_dim, generator=gen)
    k = xk[0].transpose(1, 2).repeat_interleave(4, 0)
    assert _copies_over(seq, least,
                        lambda: tw._attention(q, k, k, torch.bfloat16))


@pytest.mark.parametrize("int8_kv", [False, True])
def test_a_beam_search_counts_its_cross_rows(int8_kv, one_thread):
    """``cross_rows``: the rows of the cross K/V, one a window; the int8
    route keeps a row a beam."""
    cfg, params = _small(0, "float32")
    enc = torch.randn(3, 100, cfg.d_model,
                      generator=torch.Generator().manual_seed(2))
    stats = {}
    decode.generate(params, cfg, max_length=8, num_beams=4, enc_out=enc,
                    int8_kv=int8_kv, stats=stats)
    assert stats == {"cross_rows": 12 if int8_kv else 3}
    decode.generate(params, cfg, max_length=8, num_beams=4, enc_out=enc,
                    int8_kv=int8_kv, stats=stats)
    assert stats == {"cross_rows": 24 if int8_kv else 6}
