"""The yardstick's arithmetic: the frozen bounds reproduce the kernel
table's (PERF.md section 6) at its shapes, and the busy-time union, idle
share and rates are right on made-up intervals."""

from types import SimpleNamespace

import pytest

from perfbench import readers, roofline, trace

# the kernel table's shapes: q [4, 8, 512, 64] bf16, 500 valid keys


def test_k2_bound_matches_the_table():
    ms, by = roofline.attention_fwd_bound(4, 8, 8, 512, 64, 500)
    assert by == "bytes" and round(ms, 6) == 0.002504
    ms, by = roofline.attention_fwd_bound(4, 8, 8, 512, 64, 500, with_lse=True)
    assert by == "bytes" and round(ms, 6) == 0.002524   # K6 forward


def test_k6_backward_bounds_match_the_table():
    (dkv, by1), (dq, by2) = roofline.attention_bwd_bounds(4, 8, 8, 512, 64, 500)
    assert by1 == by2 == "operations"
    assert round(dkv, 6) == 0.004241 and round(dq, 6) == 0.003181


def test_model_flops_of_a_known_shape():
    m = {"d_model": 4, "encoder_layers": 1, "decoder_layers": 1,
         "num_mel_bins": 2, "encoder_ffn_dim": 8, "decoder_ffn_dim": 8,
         "vocab_size": 10}
    # convs 4*3*2*4 + 2*3*4*4, one layer at S 2: 4*2*16 + 2*4*4 + 2*2*4*8
    assert roofline.encoder_flops(m, 4) == 2 * (96 + 96 + 128 + 32 + 128)
    assert roofline.cross_kv_flops(m, 4) == 2 * 2 * 2 * 16


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert trace.busy_ns(iv) == 25
    assert trace.idle_gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert trace.busy_ns([]) == 0


def _view(kernels, t0, t1, **work):
    t = trace.DeviceTrace()
    t.kernels, t.t0, t.t1 = kernels, t0, t1
    return SimpleNamespace(trace=t, work=work, model={}, mix={})


def test_idle_share_mfu_and_launches():
    v = _view([(0, 250, "k"), (200, 500, "k"), (600, 700, "Memcpy DtoH")],
              0, 1000, model_flops=989e12 * 1e-6 * 0.25, windows=2)
    assert readers.idle_share(v) == pytest.approx(40.0)
    assert readers.mfu(v) == pytest.approx(25.0)
    assert readers.launches_per(v, "windows") == 1.0
    assert readers.idle_share(_view([], 0, 10)) is None


def test_breakdown_names_the_longest_idle_by_the_host():
    t = trace.DeviceTrace()
    t.t0, t.t1 = 0, 100
    t.kernels = [(0, 10, "gemm"), (40, 50, "gemm"), (50, 55, "softmax")]
    t.host = [(10, 38, "aten::item"), (60, 99, "python step")]
    b = t.breakdown()
    assert b["device_ops"][0] == ["gemm", 20 / 1e9]
    assert b["idle_gaps"][0] == ["python step", 45 / 1e9]
    assert b["idle_gaps"][1] == ["aten::item", 30 / 1e9]
