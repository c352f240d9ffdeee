"""Sampling and constrained decoding of the port (``whisperseg_torch/decode.py``)
against the JAX package's (``whisperseg_tpu/decode.py``), at float32.

The grammar (``_grammar_mask`` / ``_grammar_step``) and the nucleus filter
are held to JAX's on random states and logits. Constrained greedy ids are
identical to JAX's, on the shipped tiny checkpoint and on an untrained model
(whose unconstrained transcripts do not parse, so the mask decides most
steps). Sampled ids (``top_k`` 5, ``top_p`` 0.9, both and constrained) are
identical to JAX's when the port is fed the Gumbel noise JAX draws along
its own sequence of key splits (once a step). With the port's own ``torch.Generator`` every
constrained transcript parses and one seed gives the same ids twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperseg_tpu import decode as jdecode
from whisperseg_tpu.audio.frontend import Frontend as JaxFrontend
from whisperseg_tpu.checkpoint import load_checkpoint as jax_load
from whisperseg_tpu.models import init_params as jax_init_params
from whisperseg_tpu.models.config import make_config as jax_make_config
from whisperseg_torch import decode
from whisperseg_torch import tokenizer as tok
from whisperseg_torch.audio.frontend import Frontend
from whisperseg_torch.checkpoint import load_checkpoint, params_from_numpy
from whisperseg_torch.models.config import make_config
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import tone_bursts

TINY = "pretrained/whisperseg-tiny-animal-vad"
MAX_LENGTH = 100


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


@pytest.fixture(scope="module")
def tiny():
    """The shipped tiny checkpoint at float32 in both packages, and the
    features of two 2.5 s windows of tone bursts."""
    jparams, jcfg = jax_load(TINY)
    jcfg.compute_dtype = "float32"
    params, cfg = load_checkpoint(TINY)
    cfg.compute_dtype = "float32"
    clips = tone_bursts(3, duration=5.0).reshape(2, -1)
    feats = np.array(JaxFrontend(32000, 0.0025).features_for_clips(clips, 1000))
    return jparams, jcfg, params, cfg, feats


@pytest.fixture(scope="module")
def untrained():
    """A two-layer untrained model (random weights from one JAX key) in both
    packages: its transcripts are garbage unless constrained."""
    kw = dict(total_spec_columns=200, encoder_layers=2, decoder_layers=2,
              compute_dtype="float32")
    jcfg = jax_make_config("tiny", **kw)
    jparams = jax_init_params(jax.random.PRNGKey(7), jcfg)
    cfg = make_config("tiny", **kw)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    feats = np.random.RandomState(4).randn(2, 80, 200).astype(np.float32)
    return jparams, jcfg, params, cfg, feats


def jax_gumbel(key):
    """The port's ``noise`` callable drawing what ``jax.random.categorical``
    adds in JAX's greedy loop under ``rng=key``: one split a step, standard
    Gumbel noise of the step's shape from the new subkey."""
    state = {"rng": key}

    def draw(shape, device):
        state["rng"], sub = jax.random.split(state["rng"])
        return torch.from_numpy(np.array(
            jax.random.gumbel(sub, tuple(shape), jnp.float32))).to(device)
    return draw


def _port(setup, noise=None, **kw):
    _, _, params, cfg, feats = setup
    return decode.generate(params, cfg, torch.from_numpy(feats),
                           max_length=MAX_LENGTH, noise=noise, **kw).numpy()


def _pair(setup, key=None, **kw):
    """The port's ids and JAX's, under JAX's noise when ``key`` is given."""
    jparams, jcfg, _, _, feats = setup
    want = np.asarray(jdecode.generate(
        jparams, jcfg, jnp.asarray(feats), rng=key, max_length=MAX_LENGTH,
        **kw))
    noise = jax_gumbel(key) if key is not None else None
    return _port(setup, noise, **kw), want


def _is_ts(t):
    return tok.TIMESTAMP_BASE <= t < tok.VOCAB_SIZE


def _parses(row):
    """A transcript parses: species?, then (ts digit+ ts)* spans with
    non-decreasing columns, closed strictly after they open, then EOT and
    PAD to the end."""
    body = row[len(tok.PROMPT_IDS):]
    end = body.index(tok.EOT_ID) if tok.EOT_ID in body else len(body)
    assert all(t == tok.PAD_ID for t in body[end + 1:])
    body = body[:end]
    if body and tok.SPECIES_BASE <= body[0] < tok.TIMESTAMP_BASE:
        body = body[1:]
    last = 0
    i = 0
    while i < len(body):
        if not _is_ts(body[i]):
            return False
        open_col = body[i] - tok.TIMESTAMP_BASE
        j = i + 1
        while j < len(body) and (body[j] < 10 or body[j] >= tok.VOCAB_SIZE):
            j += 1
        if j == i + 1 or open_col < last:
            return False
        if j == len(body):  # budget ran out inside a span
            return True
        close_col = body[j] - tok.TIMESTAMP_BASE
        if not _is_ts(body[j]) or close_col <= open_col:
            return False
        last = close_col
        i = j + 1
    return True


# ------------------------------------------------------------------- grammar


@pytest.mark.parametrize("n_extra", [0, 3])
def test_grammar_mask_and_step_equal_jax(n_extra):
    rng = np.random.RandomState(n_extra)
    vocab = 1024 + 8
    mode = rng.randint(0, 4, 64)
    last_col = rng.randint(0, tok.NUM_TIMESTAMPS, 64)
    want = np.asarray(jdecode._grammar_mask(jnp.asarray(mode),
                                            jnp.asarray(last_col), vocab,
                                            n_extra))
    got = decode._grammar_mask(torch.from_numpy(mode),
                               torch.from_numpy(last_col), vocab, n_extra)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any(axis=1).all()
    # tokens of every class: digits, extended, species, timestamps, EOT, pad
    token = rng.choice(np.r_[0:30, 1000:vocab], 64)
    jm, jc = jdecode._grammar_step(jnp.asarray(mode), jnp.asarray(last_col),
                                   jnp.asarray(token), n_extra)
    m, c = decode._grammar_step(torch.from_numpy(mode),
                                torch.from_numpy(last_col),
                                torch.from_numpy(token), n_extra)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("top_p", [0.3, 0.9, 0.999])
def test_nucleus_filter_equals_jax(top_p):
    logits = np.random.RandomState(int(top_p * 1000)).randn(16, 1024) * 3
    logits = logits.astype(np.float32)
    want = np.asarray(jdecode._nucleus_filter(jnp.asarray(logits), top_p))
    got = decode._nucleus_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(got, want)
    kept = (want > -1e29).sum(axis=1)
    assert kept.min() >= 1 and kept.max() < 1024


# ---------------------------------------------------------------- decoding


@pytest.mark.parametrize("model", ["tiny", "untrained"])
def test_constrained_greedy_ids_identical_to_jax(request, model):
    setup = request.getfixturevalue(model)
    got, want = _pair(setup, constrained=True)
    np.testing.assert_array_equal(got, want)
    assert all(_parses(row.tolist()) for row in got)
    if model == "untrained":  # the mask decided: unconstrained is garbage
        assert not all(_parses(row.tolist()) for row in _port(setup))


@pytest.mark.parametrize("kw", [dict(top_k=5), dict(top_p=0.9),
                                dict(top_k=5, top_p=0.9, constrained=True)],
                         ids=["top_k", "top_p", "both_constrained"])
def test_sampled_ids_identical_to_jax_under_its_noise(tiny, kw):
    got, want = _pair(tiny, key=jax.random.PRNGKey(11), **kw)
    np.testing.assert_array_equal(got, want)
    assert (got != _port(tiny)).any()  # the noise changed some pick


def test_beam_search_ignores_sampling_and_grammar(tiny):
    """As in the JAX package (whose beam ids the port's equal,
    tests/test_torch_decode.py)."""
    opts = _port(tiny, num_beams=4, top_k=5, top_p=0.5, constrained=True)
    np.testing.assert_array_equal(opts, _port(tiny, num_beams=4))


def test_own_generator_constrained_samples_parse_and_repeat(untrained):
    _, _, params, cfg, feats = untrained
    f = torch.from_numpy(feats)

    def run(seed):
        noise = decode.gumbel_noise(torch.Generator().manual_seed(seed))
        return decode.generate(params, cfg, f, max_length=MAX_LENGTH, top_k=5,
                               top_p=0.95, constrained=True,
                               noise=noise).numpy()
    a, b, c = run(3), run(3), run(4)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert all(_parses(row.tolist()) for row in np.concatenate([a, c]))


def test_segment_samples_and_constrains_through_its_seed(tiny):
    params, cfg = tiny[2], tiny[3]
    seg = Segmenter(params, cfg, inference_dtype=None, device="cpu")
    audio = tone_bursts(5, duration=2.5)
    for kw in (dict(constrained=True), dict(top_k=5, seed=1),
               dict(top_p=0.9, seed=2)):
        # one row a batch: no padded rows to decode beside the window
        kw.update(num_beams=1, batch_size=1)
        first = seg.segment(audio, 32000, **kw)
        assert first == seg.segment(audio, 32000, **kw)
        assert len(first["onset"]) >= 3, (kw, first)
        assert all(0 <= a < b <= 2.5
                   for a, b in zip(first["onset"], first["offset"]))
    # the windows' transcripts themselves parse under the grammar
    clips, _ = seg.slice_audio_windows(audio, 32000, 0.0025, 1)
    rows = seg._generate_tokens(clips, Frontend(32000, 0.0025), 4, MAX_LENGTH,
                                1, 1.0, top_k=5, seed=1, constrained=True)
    assert all(_parses(row) for row in rows)
