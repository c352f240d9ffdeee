"""The port's training step against the JAX package's, and the properties of
what cannot be matched draw for draw (dropout, SpecAugment, remat).

Test model: 2+2 layers, d_model 128, 2 heads of 64, 200 spectrogram columns
(S 100, padded to 128), batch 2, 24 decoder positions, float32 compute.
The JAX step runs on its TPU kernel path (``tests/jax_kernel_path.py``: the
encoder attention's Pallas forward interpreted, its einsum VJP); the port
runs its plain versions on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax_kernel_path import jax_kernel_path
from whisperseg_tpu.data import build_frame_targets
from whisperseg_tpu.models import whisper as jw
from whisperseg_tpu.models.config import WhisperConfig as JaxConfig
from whisperseg_tpu.training import trainer as jt
from whisperseg_torch.checkpoint import params_from_numpy, params_to_numpy
from whisperseg_torch.models import whisper as tw
from whisperseg_torch.models.config import WhisperConfig
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.training import trainer as tt

CFG = dict(d_model=128, encoder_layers=2, decoder_layers=2, num_heads=2,
           d_ff=256, max_source_positions=100, max_target_positions=64,
           total_spec_columns=200, compute_dtype="float32")
B, L = 2, 24


def _configs(frame_head: bool):
    extra = dict(frame_head=frame_head, frame_head_clusters=2 if frame_head else 0)
    return JaxConfig(**CFG, **extra), WhisperConfig(**CFG, **extra)


def _numpy_params(jcfg):
    params = jw.init_params(jax.random.PRNGKey(0), jcfg)
    return jax.tree.map(lambda x: np.array(x, np.float32), params)


def _batch(seed: int, frame_head: bool):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, size=(B, L)).astype(np.int32)
    labels = rng.randint(0, 1024, size=(B, L)).astype(np.int32)
    ids[1, 18:] = 10       # padding
    labels[1, 17:] = -100  # ignored targets
    labels[0, :6] = rng.randint(23, 1024, size=6)  # timestamps
    batch = {"input_features": rng.uniform(-1.0, 1.5, (B, 80, 200)).astype(np.float32),
             "decoder_input_ids": ids, "labels": labels}
    if frame_head:
        per = [build_frame_targets([0.1 * (i + 1), 1.2], [0.4, 1.6], [i, 1 - i],
                                   0.01, 200) for i in range(B)]
        batch["frame_targets"] = {k: np.stack([p[k] for p in per])
                                  for k in per[0]}
    return batch


def _torch_batch(batch):
    out = dict(batch, input_features=torch.from_numpy(batch["input_features"]))
    return tt.batch_to_device(out, "cpu")


def _port_setup(np_params, cfg, lr=1e-4, warmup=0, freeze=False):
    params = tt.training_params(params_from_numpy(np_params, cfg, "cpu"), "cpu",
                                freeze_encoder=freeze)
    opt, sched, _ = tt.make_optimizer(params, lr, 0.01, warmup, 10, "linear",
                                      freeze)
    return params, opt, sched


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


@pytest.mark.parametrize("frame_head,sigma,ts_weight", [
    (False, 0.0, 1.0), (True, 1.0, 2.0)])
def test_one_step_matches_jax_build_train_step(frame_head, sigma, ts_weight):
    jcfg, cfg = _configs(frame_head)
    np_params = _numpy_params(jcfg)
    batch = _batch(0, frame_head)
    fh_weight = 1.0 if frame_head else 0.0
    # Adam's first update is g / (|g| + eps): an entry whose gradient is
    # near eps moves by up to the learning rate whatever the gradients'
    # float32 noise, so the rate is kept small enough for a 1e-6 check
    lr = 1e-5
    kwargs = dict(timestamp_loss_weight=ts_weight, timestamp_label_sigma=sigma,
                  frame_head_weight=fh_weight)

    with jax_kernel_path() as traced:
        def loss_fn(p, b):
            enc = jw.encoder_forward(p, jcfg, b["input_features"])
            logits = jw.decoder_forward_train(p, jcfg, enc, b["decoder_input_ids"])
            loss = jw.cross_entropy_loss(logits, b["labels"],
                                         timestamp_weight=ts_weight,
                                         timestamp_sigma=sigma)
            if frame_head:
                loss = loss + jw.frame_head_loss(
                    jw.frame_head_forward(p, jcfg, enc), b["frame_targets"])
            return loss

        jparams = jax.tree.map(jnp.asarray, np_params)
        jbatch = jax.tree.map(jnp.asarray, batch)
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams, jbatch)
        opt, _ = jt.make_optimizer(jparams, lr, 0.01, 0, 10, "linear", False)
        step = jt.build_train_step(jcfg, opt, **kwargs)
        want_params, _, step_loss = step(jparams, opt.init(jparams), jbatch,
                                         jax.random.PRNGKey(1))
    assert "attention.py" in traced  # the encoder ran its TPU kernel path
    want_grads = dict(_flat(jax.tree.map(np.asarray, want_grads)))
    want_params = dict(_flat(jax.tree.map(np.asarray, want_params)))

    params, popt, sched = _port_setup(np_params, cfg, lr=lr)
    step = tt.build_train_step(cfg, popt, sched, **kwargs)
    loss = step(params, _torch_batch(batch), torch.Generator().manual_seed(0))

    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert abs(float(step_loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    for name, leaf in _flat(params):
        g, w = leaf.grad.numpy(), want_grads[name]
        top = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-4 * top, (name, np.abs(g - w).max(), top)
        np.testing.assert_allclose(leaf.detach().numpy(), want_params[name],
                                   rtol=0, atol=1e-6, err_msg=name)


def test_adamw_and_schedule_match_optax():
    """b1 0.9, b2 0.999, eps 1e-8, decay scaled by the learning rate and
    masked off biases and gains; the schedule read before each update equals
    JAX's ``schedule(count)``, starting at ``schedule(0)`` (0 under warmup)."""
    warmup, lr, wd = 3, 1e-2, 0.1
    rng = np.random.RandomState(0)
    tree = {"a": {"q_w": rng.randn(4, 3).astype(np.float32),
                  "q_b": rng.randn(3).astype(np.float32)},
            "ln_g": rng.randn(3).astype(np.float32)}
    jtree = jax.tree.map(jnp.asarray, tree)
    jopt, jsched = jt.make_optimizer(jtree, lr, wd, warmup, 10, "linear", False)
    state = jopt.init(jtree)
    params = {"a": {k: torch.tensor(v, requires_grad=True)
                    for k, v in tree["a"].items()},
              "ln_g": torch.tensor(tree["ln_g"], requires_grad=True)}
    opt, sched, schedule = tt.make_optimizer(params, lr, wd, warmup, 10,
                                             "linear", False)
    for count in range(warmup + 3):
        want_lr = float(jsched(count))
        assert opt.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-6, abs=1e-12)
        assert schedule(count) == pytest.approx(want_lr, rel=1e-6, abs=1e-12)
        grads = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32), tree)
        updates, state = jopt.update(jax.tree.map(jnp.asarray, grads), state, jtree)
        jtree = optax.apply_updates(jtree, updates)
        grads, want, start = dict(_flat(grads)), dict(_flat(jtree)), dict(_flat(tree))
        for name, leaf in _flat(params):
            leaf.grad = torch.from_numpy(grads[name])
        opt.step()
        sched.step()
        for name, leaf in _flat(params):
            np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[name]),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
            if count == 0:  # schedule(0) = 0: the first update changes nothing
                assert np.array_equal(leaf.detach().numpy(), start[name])


def test_frozen_encoder_stays_bit_identical():
    jcfg, cfg = _configs(True)
    np_params = _numpy_params(jcfg)
    params, opt, sched = _port_setup(np_params, cfg, lr=1e-3, freeze=True)
    before = jax.tree.map(np.copy, params_to_numpy(params))  # not views
    step = tt.build_train_step(cfg, opt, sched, frame_head_weight=1.0)
    gen = torch.Generator().manual_seed(0)
    for seed in (0, 1):
        step(params, _torch_batch(_batch(seed, True)), gen)
    after = params_to_numpy(params)
    for name, w in _flat(before["encoder"]):
        assert np.array_equal(dict(_flat(after["encoder"]))[name], w), name
    assert not np.array_equal(after["decoder"]["layers"]["q_w"],
                              before["decoder"]["layers"]["q_w"])
    assert not np.array_equal(after["frame_head"]["h1_w"],
                              before["frame_head"]["h1_w"])


def _grads(cfg, np_params, batch, seed):
    params = tt.training_params(params_from_numpy(np_params, cfg, "cpu"), "cpu")
    gen = torch.Generator().manual_seed(seed)
    enc = tw.encoder_forward(params, cfg, batch["input_features"], train=True,
                             generator=gen)
    logits = tw.decoder_forward_train(params, cfg, enc, batch["decoder_input_ids"],
                                      train=True, generator=gen)
    tw.cross_entropy_loss(logits, batch["labels"]).backward()
    return {name: leaf.grad.clone() for name, leaf in _flat(params)}


def test_remat_gives_the_same_gradients_under_dropout():
    jcfg, cfg = _configs(False)
    np_params = _numpy_params(jcfg)
    batch = _torch_batch(_batch(2, False))
    cfg.dropout = 0.1
    plain = _grads(cfg, np_params, batch, seed=5)
    cfg.remat = True
    remat = _grads(cfg, np_params, batch, seed=5)
    other = _grads(cfg, np_params, batch, seed=6)
    for name, g in plain.items():
        torch.testing.assert_close(remat[name], g, rtol=0, atol=1e-6)
    assert not torch.equal(other["decoder.layers.q_w"], plain["decoder.layers.q_w"])


def test_init_and_frame_head_shapes_match_jax():
    """Fresh parameters have the JAX package's tree and shapes; a frame head
    of another cluster count keeps its trained layers and the columns both
    widths share, as JAX's ``ensure_frame_head`` does."""
    jcfg, cfg = _configs(True)
    np_params = _numpy_params(jcfg)
    want = dict(_flat(np_params))
    got = dict(_flat(tw.init_params(torch.Generator().manual_seed(0), cfg)))
    assert {k: v.shape for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    assert np.array_equal(got["encoder.pos_emb"].numpy(), want["encoder.pos_emb"])
    params = params_from_numpy(np_params, cfg, "cpu")
    assert tw.num_parameters(params) == jw.num_parameters(np_params)
    assert tw.ensure_frame_head(params, cfg, torch.Generator()) is params
    for clusters in (4, 1):
        jcfg.frame_head_clusters = cfg.frame_head_clusters = clusters
        j = jw.ensure_frame_head(np_params, jcfg,
                                 jax.random.PRNGKey(3))["frame_head"]
        t = tw.ensure_frame_head(params, cfg, torch.Generator())["frame_head"]
        keep = min(5, 3 + clusters)
        for k in ("ln_g", "ln_b", "h1_w", "h1_b"):
            assert np.array_equal(t[k].numpy(), np.asarray(j[k])), k
        assert t["h2_w"].shape == j["h2_w"].shape == (64, 3 + clusters)
        assert np.array_equal(t["h2_w"][:, :keep].numpy(),
                              np.asarray(j["h2_w"])[:, :keep])
        assert np.array_equal(t["h2_b"].numpy(), np.asarray(j["h2_b"]))


def test_dropout_keeps_the_right_share_and_scales_it():
    x = torch.ones(100_000)
    for rate in (0.1, 0.3):
        y = tw._dropout(x, rate, torch.Generator().manual_seed(1))
        kept = y != 0
        assert abs(kept.float().mean().item() - (1 - rate)) <= 0.01
        assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / (1.0 - rate)))


def test_spec_augment_masks_with_the_example_minimum():
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.uniform(0.1, 1.0, (3, 80, 200)).astype(np.float32))
    feats[1] -= 2.0  # another minimum per example
    fill = feats.amin(dim=(1, 2))
    gen = torch.Generator().manual_seed(0)
    only_freq = tt.spec_augment(feats, gen, n_freq_masks=1, n_time_masks=0)
    only_time = tt.spec_augment(feats, gen, n_freq_masks=0, n_time_masks=1)
    for b in range(3):
        rows = (only_freq[b] == fill[b]).all(dim=1).nonzero()[:, 0]
        assert len(rows) == 10 and rows.max() - rows.min() == 9
        cols = (only_time[b] == fill[b]).all(dim=0).nonzero()[:, 0]
        assert len(cols) == 30 and cols.max() - cols.min() == 29
    both = tt.spec_augment(feats, gen)
    changed = both != feats
    assert changed.any()
    assert torch.equal(both[changed], fill[:, None, None].expand_as(feats)[changed])


def test_segmenter_on_live_training_params_sees_updates():
    jcfg, cfg = _configs(False)
    params, opt, sched = _port_setup(_numpy_params(jcfg), cfg, lr=1e-3)
    seg = Segmenter(params, cfg, inference_dtype=None, device="cpu")
    assert seg.params is params
    feats = torch.from_numpy(_batch(3, False)["input_features"])
    with torch.no_grad():
        before = tw.encoder_forward(seg.params, cfg, feats)
    step = tt.build_train_step(cfg, opt, sched)
    for seed in (0, 1):  # the first update runs at the warmup-free full rate
        step(params, _torch_batch(_batch(seed, False)), torch.Generator())
    with torch.no_grad():
        after = tw.encoder_forward(seg.params, cfg, feats)
        fresh = tw.encoder_forward(
            params_from_numpy(params_to_numpy(params), cfg, "cpu"), cfg, feats)
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh)
    seg.update_cluster_codebook({"a": 0, "b": 1})
    assert seg.config.cluster_codebook == {"a": 0, "b": 1}
    assert seg.inverse_cluster_codebook == {0: "a", 1: "b"}


@pytest.mark.parametrize("field,value", [
    ("tp", 2), ("fsdp", True), ("use_wandb", True), ("n_device", 2)])
def test_later_slice_options_raise_naming_their_roadmap_item(field, value,
                                                             tmp_path):
    """Only ``use_wandb`` still raises (its package is absent); ``tp``,
    ``fsdp`` and ``n_device`` are accepted and size the data axis as the
    JAX package does (test_torch_parallel.py trains with them)."""
    args = tt.TrainArgs(initial_model_path="tiny", device="cpu",
                        model_folder=str(tmp_path), **{field: value})
    if field == "use_wandb":
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md Queue A item 11"):
            tt.run_training(args)
        return
    tt._check_supported(args)
    want = jt_data_width(args.batch_size, args.n_device or 4, args.tp)
    assert tt.data_width(args, args.n_device or 4) == want
    assert want * args.tp == (4 if field != "n_device" else 2)


def jt_data_width(batch_size: int, available: int, tp: int) -> int:
    """The JAX package's data width (trainer.py's run_training)."""
    dp_max = max(available // tp, 1)
    return next(d for d in range(min(dp_max, batch_size), 0, -1)
                if batch_size % d == 0)


def test_run_training_without_device_needs_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.run_training(tt.TrainArgs(model_folder=str(tmp_path)))
