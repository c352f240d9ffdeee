"""``Segmenter.segment()`` of the port against the JAX package's, end to end on
the shipped tiny checkpoint (float32 compute) with its default post-processing
on: identical tables after the 3-decimal rounding. The shipped base
checkpoint at bf16 likewise, against the JAX package's head-major path, and
the quantized modes (int8, int4, int8 cross K/V) against the JAX package on
its TPU kernel path.

Also holds the golden file (whisperseg_torch/golden_tiny.json) to the JAX
package's current output; the chip smoke run holds the port on the card to
that file. Regenerate it with ``python tests/test_torch_segmenter.py``.

The tables the card gave for the chip smoke run's bf16 requests are kept in
whisperseg_torch/card_tables_bf16.json, with each window's tokens and the
card's top-2 logit margins along them;
``python tests/test_torch_segmenter.py --card-tokens`` compares them with
JAX's head-major path window by window.
"""

import contextlib
import json
import os
import sys
import warnings

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from jax_kernel_path import jax_kernel_path  # noqa: E402
from whisperseg_tpu.audio.frontend import Frontend as JaxFrontend  # noqa: E402
from whisperseg_tpu.checkpoint import load_checkpoint as jax_load  # noqa: E402
from whisperseg_tpu.ops import attention as jatt  # noqa: E402
from whisperseg_tpu.segmenter import Segmenter as JaxSegmenter  # noqa: E402
from whisperseg_torch.checkpoint import load_checkpoint  # noqa: E402
from whisperseg_torch.segmenter import Segmenter  # noqa: E402
from whisperseg_torch.synthetic import tone_bursts  # noqa: E402

TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
BASE = os.path.join(ROOT, "pretrained", "whisperseg-base-animal-vad")
GOLDEN = os.path.join(ROOT, "whisperseg_torch", "golden_tiny.json")
CARD_TABLES = os.path.join(ROOT, "whisperseg_torch", "card_tables_bf16.json")
GOLDEN_REQUEST = {"seed": 1, "duration": 6.0, "sr": 32000, "num_beams": 4,
                  "num_trials": 3}


def _jax_segmenter():
    params, cfg = jax_load(TINY)
    cfg.compute_dtype = "float32"
    return JaxSegmenter(params, cfg, inference_dtype="float32")


def _port_segmenter():
    params, cfg = load_checkpoint(TINY)
    cfg.compute_dtype = "float32"
    return Segmenter(params, cfg, inference_dtype="float32", device="cpu")


@pytest.fixture(scope="module")
def segmenters():
    return _jax_segmenter(), _port_segmenter()


@pytest.mark.parametrize("num_beams", [1, 4])
@pytest.mark.parametrize("num_trials", [1, 3])
def test_segment_tables_identical_to_jax(segmenters, num_beams, num_trials):
    jseg, seg = segmenters
    audio = tone_bursts(0, duration=4.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # low cross-trial agreement warnings
        want = jseg.segment(audio, 32000, num_beams=num_beams,
                            num_trials=num_trials)
        got = seg.segment(audio, 32000, num_beams=num_beams,
                          num_trials=num_trials)
    assert len(want["onset"]) >= 5, want  # the comparison must bite
    assert got == want


def test_voting_consolidation_identical_to_jax(segmenters):
    jseg, seg = segmenters
    audio = tone_bursts(0, duration=4.0)
    kw = dict(num_beams=1, num_trials=3, consolidation_method="voting")
    want = jseg.segment(audio, 32000, **kw)
    assert len(want["onset"]) >= 3, want
    assert seg.segment(audio, 32000, **kw) == want


@pytest.fixture(scope="module")
def base_bf16_segmenters():
    """The base checkpoint as shipped (bf16) in both packages."""
    params, cfg = jax_load(BASE)
    return JaxSegmenter(params, cfg), Segmenter.from_pretrained(BASE, device="cpu")


@contextlib.contextmanager
def jax_head_major():
    """The JAX package with its head-major encoder path forced (its Pallas
    kernel interpreted), the path the port mirrors; on the CPU JAX otherwise
    takes its XLA attention, whose bf16 rounds elsewhere. The path is chosen
    when a program is traced, so JAX's caches are cleared on the way in and
    out."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jatt, "fused_available", lambda *a: True)
    mp.setattr(jatt, "FORCE_INTERPRET", True)
    jax.clear_caches()
    try:
        yield
    finally:
        mp.undo()
        jax.clear_caches()


def segment_head_major(jseg, audio, **kw):
    with jax_head_major(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jseg.segment(audio, 32000, **kw)


@pytest.fixture(scope="module")
def head_major_tables(base_bf16_segmenters):
    """JAX's head-major table of a request (seed, seconds, num_trials), each
    computed once for the tests of this module that need it."""
    jseg, cache = base_bf16_segmenters[0], {}

    def table(seed, duration, num_trials):
        if (seed, duration, num_trials) not in cache:
            cache[seed, duration, num_trials] = segment_head_major(
                jseg, tone_bursts(seed, duration=duration), num_trials=num_trials)
        return cache[seed, duration, num_trials]
    return table


@pytest.mark.parametrize("seed,duration,num_trials", [(101, 10.0, 1),
                                                      (106, 10.0, 3)])
def test_bf16_base_tables_identical_to_jax_head_major(base_bf16_segmenters,
                                                      head_major_tables,
                                                      seed, duration,
                                                      num_trials):
    """The shipped configuration end to end: base checkpoint, bf16, default
    arguments (beam 4 and the checkpoint's post-processing)."""
    jseg, seg = base_bf16_segmenters
    audio = tone_bursts(seed, duration=duration)
    want = head_major_tables(seed, duration, num_trials)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = seg.segment(audio, 32000, num_trials=num_trials)
    assert len(want["onset"]) >= 3, want
    assert got == want


def test_card_bf16_table_against_jax_head_major(head_major_tables):
    """The table the H100 gave for the request (106, 10 s, 3 trials) in the
    chip smoke run's bf16 serve phase, recorded in
    whisperseg_torch/card_tables_bf16.json, against JAX's head-major table
    (which the port's CPU table equals). Not identical: 4 of the request's
    14 windows leave JAX's beam-4 tokens at a step where the card's top-2
    logit margin is 0.018-0.14, a near tie between neighbouring time
    tokens that the card's other order of bf16 sums tips
    (``python tests/test_torch_segmenter.py --card-tokens``). What holds:
    every segment of JAX's table is in the card's, and the 3-trial vote
    keeps at most one segment more."""
    with open(CARD_TABLES) as f:
        card = json.load(f)
    got = next(r["table"] for r in card["tables"] if r["request"] == [106, 10.0, 3])
    want = json.loads(json.dumps(head_major_tables(106, 10.0, 3)))
    assert len(want["onset"]) >= 3, want
    segments = [set(zip(t["onset"], t["offset"], t["cluster"])) for t in (got, want)]
    assert segments[1] <= segments[0]
    assert len(segments[0] - segments[1]) <= 1


@pytest.mark.parametrize("inference_dtype,int8_kv,kernels", [
    ("int8", False, {"attention.py", "quant.py"}),
    ("int4", False, {"attention.py", "quant.py"}),
    ("int8", True, {"attention.py", "quant.py", "cross_attention.py"}),
])
def test_quantized_tables_identical_to_jax_kernel_path(inference_dtype, int8_kv,
                                                       kernels):
    """The quantized modes end to end on the tiny checkpoint, each package
    quantizing the float32 weights itself: default arguments (beam 4 and the
    checkpoint's post-processing) over 3 trials. The JAX package runs its
    w8a16 / w4a16 and int8 cross-attention Pallas kernels interpreted."""
    params, cfg = jax_load(TINY)
    jseg = JaxSegmenter(params, cfg, inference_dtype=inference_dtype)
    seg = Segmenter.from_pretrained(TINY, inference_dtype=inference_dtype,
                                    device="cpu")
    audio = tone_bursts(0, duration=4.0)
    with jax_kernel_path() as traced, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jseg.segment(audio, 32000, num_trials=3, int8_kv=int8_kv)
    assert set(traced) == kernels, traced
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = seg.segment(audio, 32000, num_trials=3, int8_kv=int8_kv)
    assert len(want["onset"]) >= 5, want  # the comparison must bite
    assert got == want


def bf16_serve_report() -> None:
    """Print, for each request of chip_smoke.py's serve phase, the base
    checkpoint's bf16 tables from the port on the CPU and from the JAX
    package on both its encoder paths, and which of them agree."""
    from chip_smoke import REQUESTS

    params, cfg = jax_load(BASE)
    jseg = JaxSegmenter(params, cfg)
    seg = Segmenter.from_pretrained(BASE, device="cpu")
    for seed, duration, trials in REQUESTS:
        audio = tone_bursts(seed, duration=duration)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            xla = jseg.segment(audio, 32000, num_trials=trials)
            port = seg.segment(audio, 32000, num_trials=trials)
        hm = segment_head_major(jseg, audio, num_trials=trials)
        print(f"seed {seed}, {duration} s, num_trials {trials}: segments "
              f"port {len(port['onset'])}, JAX head-major {len(hm['onset'])}, "
              f"JAX XLA {len(xla['onset'])}; port == head-major {port == hm}, "
              f"head-major == XLA {hm == xla}", flush=True)
        for name, table in (("port", port), ("JAX head-major", hm),
                            ("JAX XLA", xla)):
            print(f"  {name:14s} {json.dumps(table)}", flush=True)
        if port != hm:
            window_report(jseg, seg, audio, trials)


def window_report(jseg, seg, audio, trials) -> None:
    """Per window, the beam-4 tokens of the port and of JAX's XLA path
    against those of JAX's head-major path. For each window that differs:
    the first differing position and both picks' beam scores (mean
    log-probability per generated token) under JAX's jitted head-major
    model."""
    from whisperseg_tpu import tokenizer as jtok
    from whisperseg_tpu.models import whisper as jw
    from whisperseg_torch.audio.frontend import Frontend as PortFrontend

    dsc = jseg.default_segmentation_config
    clips, _ = jseg.slice_audio_windows(audio, 32000, dsc["spec_time_step"],
                                        trials)
    frontend = JaxFrontend(32000, dsc["spec_time_step"], dsc["min_frequency"])
    max_length = int(dsc["max_length"])
    params, cfg = jseg.params, jseg.config
    port = seg._generate_tokens(
        clips, PortFrontend(32000, dsc["spec_time_step"], dsc["min_frequency"]),
        4, max_length, 4, 1.0)
    jax.clear_caches()
    xla = jseg._generate_tokens(clips, frontend, 4, max_length, 4, 1, 1.0, 0,
                                None)

    @jax.jit
    def logp(feats, ids):
        enc = jw.encoder_forward(params, cfg, feats)
        xk, xv = jw.precompute_cross_kv(params, cfg, enc)
        ck, cv = jw.init_cache(cfg, ids.shape[0], ids.shape[1])
        logits = jw.decoder_step(params, cfg, xk, xv, ids, 0, ck, cv)[0]
        return jax.nn.log_softmax(logits, axis=-1)

    def eot(row):
        return row[:row.index(jtok.EOT_ID) + 1] if jtok.EOT_ID in row else row

    def score(w, row):
        feats = frontend.features_for_clips(clips[w:w + 1], cfg.total_spec_columns)
        lp = np.asarray(logp(feats, np.array([row], np.int32)))[0]
        pl = len(jtok.PROMPT_IDS)
        return float(np.mean([lp[t - 1, row[t]] for t in range(pl, len(row))]))

    with jax_head_major():
        hm = jseg._generate_tokens(clips, frontend, 4, max_length, 4, 1, 1.0,
                                   0, None)
        for name, rows in (("port", port), ("JAX XLA path", xla)):
            differ = [w for w in range(len(clips)) if eot(rows[w]) != eot(hm[w])]
            print(f"  {name}: {len(differ)} of {len(clips)} windows differ "
                  f"from JAX head-major", flush=True)
            for w in differ:
                a, b = eot(rows[w]), eot(hm[w])
                t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                print(f"    window {w}: first differing position {t}; beam "
                      f"score under JAX head-major {score(w, a):.4f}, its own "
                      f"pick {score(w, b):.4f}", flush=True)


def card_tokens_report() -> None:
    """For each request recorded from the card
    (whisperseg_torch/card_tables_bf16.json), its table and windows against
    JAX's head-major path: the windows whose beam-4 tokens differ, the first
    differing position, both picks, and the card's top-2 logit margin of
    the prediction there."""
    from whisperseg_tpu import tokenizer as jtok

    params, cfg = jax_load(BASE)
    jseg = JaxSegmenter(params, cfg)
    dsc = jseg.default_segmentation_config
    frontend = JaxFrontend(32000, dsc["spec_time_step"], dsc["min_frequency"])
    with open(CARD_TABLES) as f:
        card = json.load(f)
    for rec, toks in zip(card["tables"], card["tokens"]):
        seed, duration, trials = rec["request"]
        audio = tone_bursts(seed, duration=duration)
        clips, _ = jseg.slice_audio_windows(audio, 32000, dsc["spec_time_step"],
                                            trials)
        with jax_head_major():
            hm = jseg._generate_tokens(clips, frontend, 4, int(dsc["max_length"]),
                                       4, 1, 1.0, 0, None)
        want = segment_head_major(jseg, audio, num_trials=trials)
        hm = [row[:row.index(jtok.EOT_ID) + 1] if jtok.EOT_ID in row else row
              for row in hm]
        differ = [w for w, (a, b) in enumerate(zip(toks["tokens"], hm)) if a != b]
        print(f"request {rec['request']}: table "
              f"{'identical' if json.loads(json.dumps(want)) == rec['table'] else 'DIFFERS'}"
              f"; {len(differ)} of {len(hm)} windows' tokens differ", flush=True)
        for w in differ:
            a, b = toks["tokens"][w], hm[w]
            t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            pick = lambda row: row[t] if t < len(row) else None  # noqa: E731
            print(f"  window {w}: first differing position {t} (card {pick(a)}, "
                  f"JAX {pick(b)}); the card's top-2 logit margin there "
                  f"{toks['margins'][w][t - 1]}", flush=True)


def golden_record(jseg):
    """The JAX package's table and per-window token ids for the golden
    request."""
    req = GOLDEN_REQUEST
    audio = tone_bursts(req["seed"], sr=req["sr"], duration=req["duration"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        table = jseg.segment(audio, req["sr"], num_beams=req["num_beams"],
                             num_trials=req["num_trials"])
    dsc = jseg.default_segmentation_config
    clips, _ = jseg.slice_audio_windows(audio, req["sr"], dsc["spec_time_step"],
                                        req["num_trials"])
    frontend = JaxFrontend(req["sr"], dsc["spec_time_step"], dsc["min_frequency"])
    tokens = jseg._generate_tokens(clips, frontend, 4, int(dsc["max_length"]),
                                   req["num_beams"], 1, 1.0, 0, None)
    return {"checkpoint": "pretrained/whisperseg-tiny-animal-vad",
            "compute_dtype": "float32", "request": req, "table": table,
            "tokens": tokens}


def test_golden_file_is_the_jax_packages_output(segmenters):
    with open(GOLDEN) as f:
        golden = json.load(f)
    want = golden_record(segmenters[0])
    assert golden == json.loads(json.dumps(want))
    assert len(golden["table"]["onset"]) >= 3


def test_out_of_slice_options_raise(segmenters):
    seg = segmenters[1]
    audio = np.zeros(8000, np.float32)
    for kw in (dict(top_k=2), dict(top_p=0.5), dict(constrained=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            seg.segment(audio, 32000, **kw)
    with pytest.raises(NotImplementedError, match="speculative"):
        seg.set_draft_model(TINY)
    params, cfg = load_checkpoint(TINY)
    with pytest.raises(ValueError, match="unsupported inference_dtype"):
        Segmenter(params, cfg, inference_dtype="int2", device="cpu")
    with pytest.raises(NotImplementedError, match="HF"):
        Segmenter.from_pretrained("whisperseg-base", device="cpu")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["--bf16-serve"]:
        bf16_serve_report()
        sys.exit(0)
    if sys.argv[1:] == ["--card-tokens"]:
        card_tokens_report()
        sys.exit(0)
    with open(GOLDEN, "w") as f:
        json.dump(golden_record(_jax_segmenter()), f)
        f.write("\n")
    print(f"wrote {GOLDEN}")
