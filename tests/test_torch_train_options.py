"""The trainer's options of the JAX package in the port: adafactor, QAT
(``qat_bits``), GQA uptraining (``gqa_kv_heads``), splice augmentation
(``synth_augment``), the device-resident pool (``device_pool``) and the
profiler hook (``profile_dir``), against the JAX package on the CPU.

Adafactor: five updates from the same gradients as optax's chain,
parameters within 1e-5, the second moments factored as optax factors them.
QAT: the straight-through forward is the quantization grid bit for bit and
its gradient the identity; one step with ``qat_bits`` 8 and 4 within 1e-5
of JAX's loss. ``convert_to_gqa`` and ``synthesize_training_files`` give
the JAX package's arrays bit for bit; a GQA training step is JAX's within
1e-5. Test model as in ``tests/test_torch_train.py``: 2+2 layers, d_model
128, 2 heads of 64, 200 spectrogram columns, batch 2, float32."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax_kernel_path import jax_kernel_path
from test_torch_train import CFG, _batch, _configs, _flat, _numpy_params
from test_torch_train import _torch_batch
from test_training import make_tone_dataset
from whisperseg_tpu import augment as jaugment
from whisperseg_tpu.checkpoint import load_checkpoint as jax_load
from whisperseg_tpu.checkpoint import save_checkpoint as jax_save
from whisperseg_tpu.models import gqa as jgqa
from whisperseg_tpu.models import whisper as jw
from whisperseg_tpu.ops import quant as jq
from whisperseg_tpu.training import trainer as jt
from whisperseg_torch import augment, codec
from whisperseg_torch.checkpoint import (load_checkpoint, params_from_numpy,
                                         params_to_numpy)
from whisperseg_torch.decode import generate
from whisperseg_torch.models import gqa
from whisperseg_torch.models import whisper as tw
from whisperseg_torch.models.config import WhisperConfig
from whisperseg_torch.ops import quant
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import tone_bursts
from whisperseg_torch.training import trainer as tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port on one CPU thread while this module runs (the suite runs
    several processes at once; the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ adafactor


def _tree(rng):
    """Leaves of every kind the chain tells apart: stacked [L, in, out] and
    2-D weights with two dims >= 32 (factored over their two largest dims),
    a 2-D leaf with one small dim and 1-D biases and gains (full second
    moment), with and without weight decay."""
    return {"layers": {"q_w": rng.randn(2, 64, 48), "q_b": rng.randn(2, 48),
                       "ln_g": rng.randn(2, 48)},
            "emb": rng.randn(40, 33), "thin_w": rng.randn(3, 50),
            "out_b": rng.randn(7)}


def test_adafactor_matches_the_jax_chain():
    rng = np.random.RandomState(0)
    tree = jax.tree.map(lambda x: x.astype(np.float32), _tree(rng))
    lr, wd, warmup = 1e-2, 0.1, 2
    jtree = jax.tree.map(jnp.asarray, tree)
    jopt, jsched = jt.make_optimizer(jtree, lr, wd, warmup, 10, "linear",
                                     False, optimizer="adafactor")
    state = jopt.init(jtree)
    params = jax.tree.map(lambda x: torch.tensor(x, requires_grad=True), tree)
    opt, sched, _ = tt.make_optimizer(params, lr, wd, warmup, 10, "linear",
                                      False, optimizer="adafactor")
    assert isinstance(opt, tt.Adafactor)
    for _ in range(5):
        grads = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                             tree)
        updates, state = jopt.update(jax.tree.map(jnp.asarray, grads), state,
                                     jtree)
        jtree = optax.apply_updates(jtree, updates)
        g = dict(_flat(grads))
        for name, leaf in _flat(params):
            leaf.grad = torch.from_numpy(g[name])
        opt.step()
        sched.step()
    want = dict(_flat(jax.tree.map(np.asarray, jtree)))
    for name, leaf in _flat(params):
        moved = np.abs(want[name] - dict(_flat(tree))[name]).max()
        assert moved > 1e-3, name  # the comparison bites
        np.testing.assert_allclose(leaf.detach().numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)

    # the second moments: optax's factored row / column statistics (or a
    # full one) in the same shapes, and the same values
    fstate = state[0]
    for name, leaf in _flat(params):
        st = opt.state[leaf]
        v_row = dict(_flat(jax.tree.map(np.asarray, fstate.v_row)))[name]
        v_col = dict(_flat(jax.tree.map(np.asarray, fstate.v_col)))[name]
        v = dict(_flat(jax.tree.map(np.asarray, fstate.v)))[name]
        if "v" in st:
            assert v_row.shape == (1,) and st["v"].shape == v.shape
            np.testing.assert_allclose(st["v"].numpy(), v, rtol=1e-5)
        else:
            assert v.shape == (1,) and name in ("layers.q_w", "emb")
            np.testing.assert_allclose(st["v_row"].numpy(), v_row, rtol=1e-5)
            np.testing.assert_allclose(st["v_col"].numpy(), v_col, rtol=1e-5)


def test_adafactor_state_is_factored_and_the_model_trains():
    """The JAX test's model (``tests/test_training.py``), at the port's head
    dim of 64: the optimizer state stays far below the parameters' bytes
    (AdamW's is twice them), and the loss falls."""
    cfg = WhisperConfig(**dict(CFG, frame_head=False))
    params = tt.training_params(
        params_from_numpy(_numpy_params(_configs(False)[0]), cfg, "cpu"), "cpu")
    n_param_bytes = sum(4 * leaf.numel() for _, leaf in _flat(params))
    opt, sched, _ = tt.make_optimizer(params, 1e-3, 0.01, 0, 100, "linear",
                                      False, optimizer="adafactor")
    step = tt.build_train_step(cfg, opt, sched)
    batch = _torch_batch(_batch(0, False))
    losses = [float(step(params, batch, torch.Generator())) for _ in range(4)]
    state_bytes = sum(t.numel() * t.element_size() for st in opt.state.values()
                      for t in st.values() if isinstance(t, torch.Tensor))
    assert 0 < state_bytes < 0.1 * n_param_bytes
    assert losses[-1] < losses[0]


# ------------------------------------------------------------------------ QAT


def test_ste_forward_is_the_grid_and_its_gradient_the_identity():
    w = np.random.RandomState(8).randn(2, 256, 96).astype(np.float32)
    t = torch.from_numpy(w)
    for ste, jste, grid in (
            (quant.ste_quant8, jq.ste_quant8,
             lambda x: quant.dequantize(quant.quantize(x), torch.float32)),
            (quant.ste_quant4, jq.ste_quant4,
             lambda x: quant.unpack4(quant.quantize4(x), torch.float32))):
        got = ste(t)
        assert torch.equal(got, grid(t))
        assert np.array_equal(got.numpy(), np.asarray(jste(jnp.asarray(w))))
        x = t.clone().requires_grad_(True)
        (ste(x) * 3.0).sum().backward()
        assert torch.equal(x.grad, torch.full_like(x, 3.0))
    params = {"layers": {"q_w": t, "q_b": t[:, 0]}, "tok_emb": t[0]}
    fq = quant.fake_quantize_params(params, 8)
    assert torch.equal(fq["layers"]["q_w"], quant.ste_quant8(t))
    assert fq["layers"]["q_b"] is params["layers"]["q_b"]
    assert fq["tok_emb"] is params["tok_emb"]


@pytest.mark.parametrize("bits", [8, 4])
def test_qat_step_matches_jax(bits):
    """One step's loss within 1e-5 of JAX's ``build_train_step(qat_bits)``.
    The straight-through gradient is the plain gradient at the quantized
    weights: each leaf within 1e-4 of the leaf's largest of JAX's plain
    gradient at JAX's fake-quantized tree (the same bits as the port's).
    (JAX's jitted QAT-4 gradient itself departs from that by up to 1.7 % on
    this model: inside its program the int4 grid's products are not formed
    as written, its loss moves by 2e-7.)"""
    jcfg, cfg = _configs(False)
    np_params = _numpy_params(jcfg)
    batch = _batch(0, False)
    lr = 1e-5
    with jax_kernel_path():
        def loss_fn(p, b):
            enc = jw.encoder_forward(p, jcfg, b["input_features"])
            logits = jw.decoder_forward_train(p, jcfg, enc,
                                              b["decoder_input_ids"])
            return jw.cross_entropy_loss(logits, b["labels"])

        jparams = jax.tree.map(jnp.asarray, np_params)
        jbatch = jax.tree.map(jnp.asarray, batch)
        on_grid = jq.fake_quantize_params(jparams, bits)
        _, want_grads = jax.jit(jax.value_and_grad(loss_fn))(on_grid, jbatch)
        opt, _ = jt.make_optimizer(jparams, lr, 0.01, 0, 10, "linear", False)
        step = jt.build_train_step(jcfg, opt, qat_bits=bits)
        _, _, want_loss = step(jparams, opt.init(jparams), jbatch,
                               jax.random.PRNGKey(1))
    want_grads = dict(_flat(jax.tree.map(np.asarray, want_grads)))

    def port_step(qat_bits):
        params = tt.training_params(params_from_numpy(np_params, cfg, "cpu"),
                                    "cpu")
        opt, sched, _ = tt.make_optimizer(params, lr, 0.01, 0, 10, "linear",
                                          False)
        step = tt.build_train_step(cfg, opt, sched, qat_bits=qat_bits)
        return params, float(step(params, _torch_batch(batch),
                                  torch.Generator()))

    params, loss = port_step(bits)
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert loss != port_step(0)[1]  # the grid moved the loss
    for name, leaf in _flat(params):
        g, w = leaf.grad.numpy(), want_grads[name]
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


def test_qat4_training_makes_int4_quantization_lossless():
    """The counterpart of ``tests/test_quant4.py``'s: training through the
    int4 grid, then quantizing the float32 checkpoint to int4 reproduces
    the fake-quantized model's transcript."""
    cfg = WhisperConfig(d_model=128, encoder_layers=2, decoder_layers=2,
                        num_heads=2, d_ff=128, max_source_positions=32,
                        max_target_positions=64, total_spec_columns=64,
                        compute_dtype="float32")
    params = tt.training_params(
        tw.init_params(torch.Generator().manual_seed(0), cfg), "cpu")
    feats = torch.from_numpy(
        np.random.RandomState(0).randn(1, 80, 64).astype(np.float32))
    target = codec.build_target_ids("unknown", [0.02, 0.2], [0.1, 0.4],
                                    [0, 1], 0.01, 64)
    inputs, labels = codec.shift_for_training(target, max_length=16)
    batch = {"input_features": feats,
             "decoder_input_ids": torch.tensor([inputs]),
             "labels": torch.tensor([labels])}
    opt = torch.optim.Adam([leaf for _, leaf in _flat(params)], lr=1e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    step = tt.build_train_step(cfg, opt, sched, qat_bits=4)
    losses = [float(step(params, batch, torch.Generator()))
              for _ in range(150)]
    assert losses[-1] < 0.1, losses[-10:]
    with torch.no_grad():
        fake = generate(quant.fake_quantize_params(params, 4), cfg, feats,
                        max_length=32)
        real = generate(quant.quantize_params(params, bits=4), cfg, feats,
                        max_length=32)
    assert fake[0, :len(target)].tolist() == list(target)  # it learned it
    assert torch.equal(real, fake)


# ------------------------------------------------------------------------ GQA


def test_convert_to_gqa_bit_identical_to_jax():
    jparams, jcfg = jax_load(TINY)
    params, cfg = load_checkpoint(TINY)
    for kv in (3, 2):
        want, wcfg = jgqa.convert_to_gqa(jparams, jcfg, kv)
        got, gcfg = gqa.convert_to_gqa(params, cfg, kv)
        assert gcfg.to_dict() == wcfg.to_dict()
        assert gcfg.kv_heads == kv and cfg.kv_heads == 6
        want = dict(_flat(jax.tree.map(np.asarray, want)))
        got = dict(_flat(params_to_numpy(got)))
        assert got.keys() == want.keys() and "frame_head.h1_w" not in got
        for name, w in want.items():
            assert np.array_equal(got[name], w), name
        assert got["encoder.layers.k_w"].shape == (4, 384, 64 * kv)
    with pytest.raises(ValueError):
        gqa.convert_to_gqa(params, cfg, 4)


def test_gqa_training_step_matches_jax():
    """One step of the converted model (2 query heads on 1 K/V head)."""
    jcfg, cfg = _configs(True)
    np_params = _numpy_params(jcfg)
    jparams, jcfg = jgqa.convert_to_gqa(jax.tree.map(jnp.asarray, np_params),
                                        jcfg, 1)
    # the conversion keeps the encoder and the decoder; the head goes back in
    jparams = {**jparams, "frame_head": jax.tree.map(jnp.asarray,
                                                     np_params["frame_head"])}
    np_gqa = jax.tree.map(np.asarray, jparams)
    batch = _batch(1, True)
    lr = 1e-5
    with jax_kernel_path():
        opt, _ = jt.make_optimizer(jparams, lr, 0.01, 0, 10, "linear", False)
        step = jt.build_train_step(jcfg, opt, frame_head_weight=1.0)
        want_params, _, want_loss = step(jparams, opt.init(jparams),
                                         jax.tree.map(jnp.asarray, batch),
                                         jax.random.PRNGKey(1))
    params, cfg = gqa.convert_to_gqa(params_from_numpy(np_params, cfg, "cpu"),
                                     cfg, 1)
    params["frame_head"] = params_from_numpy(np_params, _configs(True)[1],
                                             "cpu")["frame_head"]
    assert cfg.kv_heads == 1
    params = tt.training_params(params, "cpu")
    for name, leaf in _flat(params):
        assert np.array_equal(leaf.detach().numpy(),
                              dict(_flat(np_gqa))[name]), name
    popt, sched, _ = tt.make_optimizer(params, lr, 0.01, 0, 10, "linear", False)
    loss = tt.build_train_step(cfg, popt, sched, frame_head_weight=1.0)(
        params, _torch_batch(batch), torch.Generator())
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_params = dict(_flat(jax.tree.map(np.asarray, want_params)))
    for name, leaf in _flat(params):
        np.testing.assert_allclose(leaf.detach().numpy(), want_params[name],
                                   rtol=0, atol=1e-6, err_msg=name)


# ----------------------------------------------------------- splice synthesis


def _corpus():
    """Three annotated files at two frontend configurations, labelled as
    ``load_data`` leaves them."""
    rng = np.random.RandomState(3)
    audio, labels = [], []
    for i, (sr, step) in enumerate([(32000, 0.0025), (32000, 0.0025),
                                    (16000, 0.01)]):
        seconds = 4.0
        onset = np.sort(rng.uniform(0.1, seconds - 0.4, 6))
        offset = onset + rng.uniform(0.02, 0.2, 6)
        audio.append(tone_bursts(20 + i, sr=sr, duration=seconds))
        labels.append({"sr": sr, "spec_time_step": step, "min_frequency": 0,
                       "onset": onset, "offset": offset,
                       "cluster": [str(c) for c in rng.randint(0, 3, 6)],
                       "cluster_id": rng.randint(0, 3, 6),
                       "species": "unknown"})
    return audio, labels


def test_synthesize_training_files_bit_identical_to_jax():
    audio, labels = _corpus()
    for seed in (0, 1):
        np.random.seed(seed)  # the default generator's seed is drawn from it
        want_a, want_l = jaugment.synthesize_training_files(
            audio, labels, 5, total_spec_columns=400)
        np.random.seed(seed)
        got_a, got_l = augment.synthesize_training_files(
            audio, labels, 5, total_spec_columns=400)
        assert len(got_a) == len(want_a) >= 4
        for ga, wa, gl, wl in zip(got_a, want_a, got_l, want_l):
            assert ga.dtype == wa.dtype and np.array_equal(ga, wa)
            assert gl.keys() == wl.keys()
            for k in wl:
                assert np.array_equal(np.asarray(gl[k]), np.asarray(wl[k])), k
    kw = dict(total_spec_columns=400, time_stretch=0.0, amp_db=3.0)
    want = jaugment.synthesize_training_files(
        audio, labels, 3, rng=np.random.default_rng(5), **kw)
    got = augment.synthesize_training_files(
        audio, labels, 3, rng=np.random.default_rng(5), **kw)
    assert all(np.array_equal(g, w) for g, w in zip(got[0], want[0]))


# ------------------------------------------------- the options end to end


@pytest.fixture(scope="module")
def initial(tmp_path_factory):
    """A random 2+2-layer model (2 heads of 64) saved as a checkpoint, and a
    folder of tone recordings with labels."""
    root = tmp_path_factory.mktemp("options")
    jcfg, _ = _configs(False)
    jax_save(str(root / "init"), _numpy_params(jcfg), jcfg)
    return root, make_tone_dataset(str(root / "data"), n_files=4)


RUN = dict(batch_size=2, max_length=24, total_spec_columns=200,
           learning_rate=1e-3, warmup_steps=2, num_workers=2, device="cpu")


def _metrics(folder):
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_training_with_the_options_end_to_end(initial, capsys):
    """adafactor + QAT-8 + GQA (one K/V head) + two synthesized files +
    the profiler hook, 15 steps: finite losses, a Chrome trace of steps
    10-14, a grouped checkpoint that segments."""
    root, data = initial
    folder = str(root / "model")
    final = tt.run_training(tt.TrainArgs(
        initial_model_path=str(root / "init"), model_folder=folder,
        train_dataset_folder=data, max_num_iterations=15, print_every=5,
        optimizer="adafactor", qat_bits=8, gqa_kv_heads=1, synth_augment=2,
        profile_dir=str(root / "trace"), **RUN))
    out = capsys.readouterr().out
    assert "Converted initial model to GQA (kv_heads=1)." in out
    assert "Synth augmentation: +2 file(s)" in out
    losses = [m["train/loss"] for m in _metrics(folder)]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    traces = os.listdir(str(root / "trace"))
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(str(root / "trace"), traces[0])) as f:
        assert json.load(f)["traceEvents"]
    params, cfg = load_checkpoint(final)
    assert cfg.kv_heads == 1 and params["encoder"]["layers"]["k_w"].shape[-1] == 64
    seg = Segmenter(params, cfg, inference_dtype="float32", device="cpu")
    table = seg.segment(tone_bursts(0, duration=2.0), 32000, num_beams=1,
                        max_length=24)
    assert set(table) == {"onset", "offset", "cluster"}


def test_device_pool_end_to_end(initial, monkeypatch):
    """Two epoch blocks of the device-resident pool (4 files of 4 s sliced
    to 2 s windows: 8 items, 4 steps a block) and a cut third block, saved
    at the block boundaries past each multiple of 4 steps and at the end."""
    root, data = initial
    folder = str(root / "pool")
    saved = []
    inner = tt.save_training_checkpoint

    def save(model_folder, params, cfg, step, *args, **kwargs):
        saved.append(step)
        return inner(model_folder, params, cfg, step, *args, **kwargs)
    monkeypatch.setattr(tt, "save_training_checkpoint", save)
    final = tt.run_training(tt.TrainArgs(
        initial_model_path=str(root / "init"), model_folder=folder,
        train_dataset_folder=data, max_num_iterations=10, device_pool=True,
        save_every=4, **RUN))
    records = [m for m in _metrics(folder) if "train/loss" in m]
    assert [m["current_step"] for m in records] == [4, 8, 10]
    assert np.all(np.isfinite([m["train/loss"] for m in records]))
    assert saved == [4, 8, 10]
    params, cfg = load_checkpoint(final)
    assert cfg.current_step == 10
    seg = Segmenter(params, cfg, inference_dtype="float32", device="cpu")
    assert set(seg.segment(tone_bursts(0, duration=2.0), 32000, num_beams=1,
                           max_length=24)) == {"onset", "offset", "cluster"}
