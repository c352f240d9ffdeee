"""Synthetic pretraining in the port (``whisperseg_torch/pretrain.py``)
against the JAX package's ``whisperseg_tpu/pretrain.py`` on the CPU.

``gen_example`` and ``make_items`` give the JAX package's audio, labels and
targets bit for bit under one ``RandomState``; ``collate_pool``'s features
are JAX's within 1e-5 but for a few bins (all within 5e-5);
``build_scan_train_step`` runs K
optimizer steps over a pool with JAX's losses within 1e-4 (dropout 0 and
SpecAugment off, whose random draws the two packages cannot share), and
``build_eval_loss`` gives JAX's loss within 1e-5. ``run_pretraining`` and
``python -m whisperseg_torch.pretrain`` run end to end, and their
checkpoint segments. Test model: 2+2 layers, d_model 128, 2 heads of 64, a
frame head of 5 clusters, 200 spectrogram columns."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_kernel_path import jax_kernel_path
from test_torch_train import CFG
from whisperseg_tpu import pretrain as jp
from whisperseg_tpu.models import whisper as jw
from whisperseg_tpu.models.config import WhisperConfig as JaxConfig
from whisperseg_tpu.training import trainer as jt
from whisperseg_torch import pretrain as tp
from whisperseg_torch.checkpoint import load_checkpoint, params_from_numpy
from whisperseg_torch.models.config import WhisperConfig
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import tone_bursts
from whisperseg_torch.training import trainer as tt

MODEL = dict(CFG, frame_head=True, frame_head_clusters=5)
SPEC = dict(total_spec_columns=200, max_length=24, chunk=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port on one CPU thread while this module runs (the suite runs
    several processes at once; the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_pretrain_configs_and_gen_example_bit_identical_to_jax():
    assert tp.PRETRAIN_CONFIGS == jp.PRETRAIN_CONFIGS
    for i, (sr, step, fmin) in enumerate(tp.PRETRAIN_CONFIGS):
        for seed in (i, 100 + i):
            wa, wl = jp.gen_example(np.random.RandomState(seed), sr, step,
                                    fmin, 1000)
            ga, gl = tp.gen_example(np.random.RandomState(seed), sr, step,
                                    fmin, 1000)
            assert ga.dtype == wa.dtype and np.array_equal(ga, wa)
            assert gl.keys() == wl.keys()
            for k in wl:
                assert np.array_equal(np.asarray(gl[k]), np.asarray(wl[k])), k


@pytest.fixture(scope="module")
def items():
    """``make_items`` of both packages: one chunk of 2 examples for each of
    the six configurations."""
    return (jp.make_items(7, 12, jp.PoolSpec(**SPEC)),
            tp.make_items(7, 12, tp.PoolSpec(**SPEC), device="cpu"))


def test_make_items_bit_identical_to_jax(items):
    want, got = items
    assert len(got) == len(want) == 6
    for (_, w_items), (ds, g_items) in zip(want, got):
        assert len(g_items) == len(w_items) == 2
        assert ds.device == torch.device("cpu")
        for g, w in zip(g_items, w_items):
            assert g["frontend_key"] == w["frontend_key"]
            for k in ("audio_clip", "decoder_input_ids", "labels"):
                assert np.array_equal(g[k], w[k]), k
            for k in w["frame_targets"]:
                assert np.array_equal(g["frame_targets"][k],
                                      w["frame_targets"][k]), k


def test_collate_pool_matches_jax(items):
    """Features of every configuration (n_fft 512, 1024 and 4096): all but
    0.1 % of them within 1e-5 of JAX's, every one within 5e-5 (the FFTs sum
    in another order and log10 of a small mel power magnifies it: measured
    19 of 192000 values above 1e-5, at most 2.9e-5 at 48 kHz; the frontend's
    own test holds it to 2e-5 at n_fft 512); ids, labels and targets
    equal."""
    want = jp.collate_pool(items[0], jp.PoolSpec(**SPEC))
    got = tp.collate_pool(items[1], tp.PoolSpec(**SPEC))
    f, wf = got["input_features"].numpy(), want["input_features"]
    assert f.shape == wf.shape == (12, 80, 200)
    err = np.abs(f - wf)
    assert np.mean(err > 1e-5) < 1e-3 and err.max() < 5e-5, err.max()
    assert got["labels"].dtype == torch.long
    assert np.array_equal(got["labels"].numpy(), want["labels"])
    assert np.array_equal(got["decoder_input_ids"].numpy(),
                          want["decoder_input_ids"])
    for k, v in want["frame_targets"].items():
        assert np.array_equal(got["frame_targets"][k].numpy(), v), k


def test_scan_train_step_and_eval_loss_match_jax(items):
    """Three steps over the same pool and indices from the same float32
    parameters, AdamW with warmup: losses within 1e-4; then the evaluation
    loss of the trained parameters on one batch within 1e-5."""
    jcfg, cfg = JaxConfig(**MODEL), WhisperConfig(**MODEL)
    np_params = jax.tree.map(lambda x: np.array(x, np.float32),
                             jw.init_params(jax.random.PRNGKey(0), jcfg))
    pool = jp.collate_pool(items[0], jp.PoolSpec(**SPEC))
    idx = np.random.RandomState(0).randint(0, 12, (3, 2)).astype(np.int32)
    kw = dict(use_spec_augment=False)
    with jax_kernel_path():
        jparams = jax.tree.map(jnp.asarray, np_params)
        opt, _ = jt.make_optimizer(jparams, 1e-3, 0.01, 1, 10, "linear", False)
        train_k = jp.build_scan_train_step(jcfg, opt, 3, 2, **kw)
        jparams, _, want = train_k(jparams, opt.init(jparams),
                                   jax.tree.map(jnp.asarray, pool),
                                   jnp.asarray(idx), jax.random.PRNGKey(0))
        batch = jax.tree.map(lambda a: jnp.asarray(a[:2]), pool)
        want_eval = float(jp.build_eval_loss(jcfg)(jparams, batch))

    params = tt.training_params(params_from_numpy(np_params, cfg, "cpu"), "cpu")
    popt, sched, _ = tt.make_optimizer(params, 1e-3, 0.01, 1, 10, "linear",
                                       False)
    train_k = tp.build_scan_train_step(cfg, popt, sched, 3, 2, **kw)
    tpool = tp.collate_pool(items[1], tp.PoolSpec(**SPEC))
    tpool["input_features"] = torch.from_numpy(pool["input_features"])
    got = train_k(params, tpool, torch.from_numpy(idx).long(),
                  torch.Generator())
    assert got.shape == (3,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert got[2] < got[0]
    got_eval = float(tp.build_eval_loss(cfg)(params, tp._slice(tpool, 0, 2)))
    assert abs(got_eval - want_eval) <= 1e-5 * abs(want_eval)
    with pytest.raises(ValueError):
        train_k(params, tpool, torch.zeros((4, 2), dtype=torch.long),
                torch.Generator())


def _check_checkpoint(final: str, steps: int):
    params, cfg = load_checkpoint(final)
    assert cfg.frame_head and cfg.frame_head_clusters == 5
    assert cfg.current_step == steps
    seg = Segmenter(params, cfg, inference_dtype="float32", device="cpu")
    table = seg.segment(tone_bursts(0, duration=2.0), 32000, num_beams=1,
                        max_length=24, spec_time_step=0.01)
    assert set(table) == {"onset", "offset", "cluster"}


def test_run_pretraining_end_to_end(tmp_path):
    """The tiny family size at 200 columns: 4 steps in calls of 2 over a
    pool of one example a configuration, refreshed every 2 steps by the
    worker thread; losses logged finite, the checkpoint segments."""
    folder = str(tmp_path / "pt")
    final = tp.run_pretraining(tp.PretrainArgs(
        model="tiny", model_folder=folder, steps=4, batch_size=2,
        pool_items=6, refresh_every=2, steps_per_call=2, warmup_steps=1,
        dropout=0.0, save_every=4, device="cpu",
        spec=tp.PoolSpec(total_spec_columns=200, max_length=24, chunk=1)))
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["current_step"] for r in records] == [2, 4]
    assert all(np.isfinite([r["train/loss"], r["val/loss"]]).all()
               for r in records)
    _check_checkpoint(final, 4)


def test_module_cli_runs(tmp_path, monkeypatch):
    """``python -m whisperseg_torch.pretrain`` takes the flags of
    ``scripts/pretrain_synthetic.py`` (and ``--device``)."""
    monkeypatch.setattr(tp, "PoolSpec", functools.partial(tp.PoolSpec,
                                                          chunk=1))
    folder = str(tmp_path / "cli")
    final = tp.main(["--model", "tiny", "--model_folder", folder,
                     "--steps", "2", "--batch_size", "2", "--pool_items", "6",
                     "--refresh_every", "2", "--steps_per_call", "2",
                     "--warmup_steps", "1", "--dropout", "0.0",
                     "--save_every", "2", "--total_spec_columns", "200",
                     "--max_length", "24", "--device", "cpu"])
    _check_checkpoint(final, 2)
