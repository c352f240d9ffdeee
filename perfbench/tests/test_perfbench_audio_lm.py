"""The audio-LM cell (``moonlight.segment``): a whole run on the CPU at a
tiny size is correct and one with a served token altered is not; its
configuration holds every number of the published config; the expert
roofline's arithmetic; the reference imports nothing of the port; and, on
the card at the cell's own size, the float8 control fails the limit; the
two new readers on hand-built views."""

import contextlib
import copy
import json
import math
import os

import pytest
import torch

from perfbench import calibrate, common, faults, roofline, roofline_moe, run
from perfbench import weights_audio_lm as wal

CELL = "moonlight.segment"
TINY = {"d_model": 128, "encoder_layers": 1, "encoder_attention_heads": 2,
        "encoder_ffn_dim": 256, "hidden_size": 64, "num_hidden_layers": 3,
        "num_attention_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 16, "v_head_dim": 16, "intermediate_size": 128,
        "moe_intermediate_size": 32, "n_routed_experts": 8,
        "n_shared_experts": 1, "num_experts_per_tok": 2, "vocab_size": 1024}
SMALL = {"recording_s": 5.0, "pool": 2, "batch_size": 4, "check_windows": 6,
         "max_length": 8}


def tiny() -> common.Cell:
    cell = copy.deepcopy(common.load_cell(CELL))
    cell.model.update(TINY)
    cell.mix.update(SMALL)
    return cell


def drive(options=None, patch=None, seed=2 ** 35 + 11):
    args = run.parse(["--workload", CELL, "--seed", str(seed),
                      "--seconds", "1", "--trace", "0"])
    with patch() if patch else contextlib.nullcontext():
        return run.execute(args, tiny(), torch.device("cpu"), options)


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_a_sound_run_is_correct_and_reads_the_control():
    result, _raw, out = drive({"control": True})
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert out["check"]["tokens"] > 0
    assert out["check"]["control_tokens"] == out["check"]["tokens"]


def test_a_served_token_altered_is_not_correct():
    result, _raw, _out = drive(patch=faults.token)
    assert not result["correct"], result["compared"]


def test_the_configuration_holds_the_published_numbers():
    """Every number of Moonlight-16B-A3B's published config.json under its
    own key (the catalog row's ``config``), the encoder as whisper-large-v2's,
    and the one cut in ``reduced``."""
    published = {
        "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1,
        "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 11264,
        "kv_lora_rank": 512, "max_position_embeddings": 8192,
        "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
        "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
        "n_shared_experts": 2, "norm_topk_prob": True,
        "num_attention_heads": 16, "num_experts_per_tok": 6,
        "num_hidden_layers": 27, "num_key_value_heads": 16,
        "num_nextn_predict_layers": 0, "q_lora_rank": None,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
        "rms_norm_eps": 1e-05, "rope_theta": 50000,
        "routed_scaling_factor": 2.446, "scoring_func": "sigmoid",
        "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
        "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 163840}
    model = common.load_cell(CELL).model
    assert {k: model[k] for k in published} == published
    assert (model["d_model"], model["encoder_layers"],
            model["encoder_attention_heads"], model["encoder_ffn_dim"]) == \
        (1280, 32, 20, 5120)
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        conf = next(c for c in json.load(f)["configs"]
                    if c["name"] == model["name"])
    assert conf["reduced"] == ["max_source_positions"]
    assert model["published"] == {"max_source_positions": 1500}


def test_the_layout_holds_the_published_parameter_count():
    """~16.0 B parameters in the LM (Moonlight-16B-A3B) and ~0.64 B in the
    encoder, from the layout alone."""
    model = common.load_cell(CELL).model
    sizes = {k: math.prod(s) for k, s, _, _ in wal.layout(model)}
    lm = sum(v for k, v in sizes.items() if k.startswith("lm."))
    enc = sum(v for k, v in sizes.items() if k.startswith("encoder."))
    assert 15.9e9 < lm < 16.1e9 and 0.6e9 < enc < 0.7e9


def test_the_expert_roofline_arithmetic():
    m = common.load_cell(CELL).model
    # one decode step of 64 rows: 384 pairs, every expert of 26 layers hit
    per_layer = 3 * 2048 * 1408 * 2
    assert roofline_moe.expert_weight_bytes(m, 2) == per_layer
    b = roofline_moe.moe_bytes(m, 384 * 26, 64 * 26)
    assert 64 * 26 * per_layer < b < 1.01 * 64 * 26 * per_layer
    ms = roofline_moe.moe_bound_ms(m, {"routed_decode": 384 * 26,
                                       "experts_decode": 64 * 26})
    assert ms == pytest.approx(b / roofline.HBM_BYTES_PER_S * 1e3)
    # a prefill of 16 x 503 tokens is bound by the operations
    routed = 16 * 503 * 6 * 26
    ms = roofline_moe.moe_bound_ms(m, {"routed_prefill": routed,
                                       "experts_prefill": 64 * 26})
    assert ms == pytest.approx(roofline_moe.moe_flops(m, routed)
                               / roofline.PEAK_FLOPS["bfloat16"] * 1e3)
    # active parameters: ~3 B a token (Moonlight-16B-A3B), ~6 GFLOP
    token = roofline_moe.lm_flops(m, 1, 0) + roofline_moe.head_flops(m)
    assert 5.0e9 < token < 7.0e9


def test_the_benchmark_reference_imports_nothing_of_the_port():
    from perfbench.tests.test_perfbench_imports import loaded_tops
    tops = loaded_tops(["perfbench.reference.audio_lm",
                        "perfbench.roofline_moe"])
    assert not tops & set(common.FORBIDDEN + ("whisperseg_torch",))


@pytest.mark.card
def test_the_float8_control_is_not_correct_on_the_card(card):
    """The reference in float8 over the windows of three sound runs at the
    cell's own size: each fails the cell's limit."""
    cell = common.load_cell(CELL)
    for seed in (4_100_000_001, 4_100_000_002, 4_100_000_003):
        numbers = calibrate.one(cell, seed, 5, card, calibrate.PROGRAM)
        read = {k[len("control_"):]: v for k, v in numbers.items()
                if k.startswith("control_")}
        compared = common.judge(read, cell.limits)
        assert not common.passed(compared), (seed, compared)


def _span_view(monkeypatch, records, kernels=()):
    from perfbench import spans
    from perfbench.tests.test_perfbench_spans import view

    v = view(records, kernels=kernels)
    v.model = common.load_cell(CELL).model
    monkeypatch.setattr(spans, "_recorded", lambda lo, hi: list(records))
    return v


def test_the_prefill_reader(monkeypatch):
    from perfbench.tests.test_perfbench_spans import rec

    records = [rec("segment.prefill", 10, 40, 1, windows=16),
               rec("segment.prefill", 50, 70, 2, windows=16)]
    v = _span_view(monkeypatch, records)
    assert run.read_metric("prefill_ms_per_window.segment", v) == \
        pytest.approx(50 / 32)
    assert run.read_metric("prefill_ms_per_window.segment",
                           _span_view(monkeypatch, [])) is None


def test_the_expert_roofline_reader(monkeypatch):
    """The bound of the counted load over the device time of the grouped
    GEMM's kernels (the products and the layout of their groups); None
    without counts (a parent program)."""
    from perfbench.tests.test_perfbench_spans import MS, rec

    counts = {"routed_prefill": 16 * 503 * 6 * 26, "experts_prefill": 1664,
              "busiest_prefill": 26 * 900, "routed_decode": 384 * 26,
              "experts_decode": 1664, "busiest_decode": 26 * 15}
    records = [rec("segment.decode", 0, 900, 1, **counts)]
    gemm = ("void cutlass::device_kernel<at::cuda::detail::enable_3x_kernel"
            "_for_sm9x<cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::"
            "GroupProblemShape<cute::tuple<int, int, int> >")
    kernels = [(0, 38 * MS, gemm),
               (40 * MS, 42 * MS, "void at::cuda::detail::prepare_grouped_"
                "gemm_data<cutlass::bfloat16_t>"),
               (50 * MS, 80 * MS, gemm),
               (90 * MS, 95 * MS, "attention_hm_tc_kernel")]
    v = _span_view(monkeypatch, records, kernels)
    m = v.model
    want = 100 * roofline_moe.moe_bound_ms(m, counts) / 70.0
    assert run.read_metric("moe_roofline.segment", v) == pytest.approx(want)
    assert 0 < want < 100
    bare = _span_view(monkeypatch, [rec("segment.decode", 0, 900, 1)],
                      kernels)
    assert run.read_metric("moe_roofline.segment", bare) is None
