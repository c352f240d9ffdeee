"""``run_training(device="cpu")`` against the JAX package's ``run_training``:
the same tone dataset (``tests/test_training.py::make_tone_dataset``), the
same float32 initial checkpoint, 20 steps logged every 5. The data pipeline
draws on the global ``np.random`` stream in the same order, so the batches
are the same; the logged losses agree within 1e-4 relative; each package
loads the other's ``final_checkpoint``. With the frame head on, the initial
checkpoint already holds one (each package's ``ensure_frame_head`` draws
its own random init)."""

import json
import os

import jax
import numpy as np
import pytest

from test_training import make_tone_dataset
from whisperseg_tpu import data as jdata
from whisperseg_tpu.checkpoint import load_checkpoint as jax_load
from whisperseg_tpu.checkpoint import save_checkpoint as jax_save
from whisperseg_tpu.models.config import WhisperConfig as JaxConfig
from whisperseg_tpu.models.whisper import ensure_frame_head, init_params
from whisperseg_tpu.training import TrainArgs as JaxArgs
from whisperseg_tpu.training import run_training as jax_run_training
from whisperseg_torch import data as tdata
from whisperseg_torch.checkpoint import load_checkpoint, params_to_numpy
from whisperseg_torch.training import TrainArgs, run_training

CFG = dict(d_model=128, encoder_layers=2, decoder_layers=2, num_heads=2,
           d_ff=256, max_source_positions=100, max_target_positions=64,
           total_spec_columns=200, compute_dtype="float32")
RUN = dict(max_num_iterations=20, batch_size=2, max_length=24,
           total_spec_columns=200, learning_rate=1e-3, warmup_steps=5,
           print_every=5, num_workers=2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    data = make_tone_dataset(str(root / "data"), n_files=6)
    cfg = JaxConfig(**CFG)
    params = init_params(jax.random.PRNGKey(0), cfg)
    jax_save(str(root / "init"), params, cfg)
    cfg.frame_head, cfg.frame_head_clusters = True, 1  # one cluster: "Vocal"
    jax_save(str(root / "init_fh"),
             ensure_frame_head(params, cfg, jax.random.PRNGKey(7)), cfg)
    return root, data


class _Batches:
    """Records the ids and labels of the first batches a package's
    ``VocalSegDataset.collate`` makes."""

    def __init__(self, module, monkeypatch, n=5):
        self.seen = []
        orig = module.VocalSegDataset.collate

        def collate(dataset, items):
            batch = orig(dataset, items)
            if len(self.seen) < n:
                self.seen.append((batch["decoder_input_ids"].copy(),
                                  batch["labels"].copy()))
            return batch

        monkeypatch.setattr(module.VocalSegDataset, "collate", collate)


def _losses(folder):
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        return [json.loads(line)["train/loss"] for line in f]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, np.asarray(v)


@pytest.mark.parametrize("frame_head", [False, True])
def test_run_training_matches_jax(setup, frame_head, monkeypatch):
    root, data = setup
    init = str(root / ("init_fh" if frame_head else "init"))
    jax_folder = str(root / f"jax_{frame_head}")
    port_folder = str(root / f"port_{frame_head}")

    jax_batches = _Batches(jdata, monkeypatch)
    jax_final = jax_run_training(JaxArgs(
        initial_model_path=init, model_folder=jax_folder,
        train_dataset_folder=data, frame_head=frame_head, n_device=1, **RUN))
    port_batches = _Batches(tdata, monkeypatch)
    port_final = run_training(TrainArgs(
        initial_model_path=init, model_folder=port_folder,
        train_dataset_folder=data, frame_head=frame_head, device="cpu", **RUN))

    assert len(port_batches.seen) == len(jax_batches.seen) == 5
    for (ids, labels), (jids, jlabels) in zip(port_batches.seen, jax_batches.seen):
        assert np.array_equal(ids, jids) and np.array_equal(labels, jlabels)

    want, got = _losses(jax_folder), _losses(port_folder)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)

    # each package loads the other's final checkpoint, arrays and config equal
    port_params, port_cfg = load_checkpoint(port_final)
    jax_params, jax_cfg = jax_load(port_final)
    assert port_cfg.to_dict() == jax_cfg.to_dict()
    assert port_cfg.frame_head == frame_head and port_cfg.current_step == 20
    want_flat = dict(_flat(jax.tree.map(np.asarray, jax_params)))
    got_flat = dict(_flat(params_to_numpy(port_params)))
    assert want_flat.keys() == got_flat.keys()
    for name, w in want_flat.items():
        assert np.array_equal(got_flat[name], w), name
    port_params, port_cfg = load_checkpoint(jax_final)
    jax_params, jax_cfg = jax_load(jax_final)
    assert port_cfg.to_dict() == jax_cfg.to_dict()
    for name, g in _flat(params_to_numpy(port_params)):
        assert np.array_equal(g, dict(_flat(jax.tree.map(np.asarray,
                                                         jax_params)))[name])
    with open(os.path.join(port_final, "config.json")) as f:
        meta = json.load(f)
    assert meta["__storage_dtype__"] == "float32"
    assert meta["default_segmentation_config"]["max_length"] == RUN["max_length"]


def test_run_training_validates_on_the_live_weights(setup):
    """``val_ratio`` > 0: validation segments the held-out parts with the
    weights being trained, saves each new best, and the final checkpoint is
    the best validated step's."""
    root, data = setup
    folder = str(root / "port_val")
    final = run_training(TrainArgs(
        initial_model_path=str(root / "init"), model_folder=folder,
        train_dataset_folder=data, device="cpu", val_ratio=0.3,
        validate_every=5, **dict(RUN, max_num_iterations=10)))
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        scores = [json.loads(line) for line in f if "validate/score" in line]
    assert [s["current_step"] for s in scores] == [5, 10]
    assert all(0.0 <= s["validate/score"] <= 1.0 for s in scores)
    best = max(scores, key=lambda s: s["validate/score"])["current_step"]
    assert load_checkpoint(final)[1].current_step == best
    assert sorted(os.listdir(folder)) == ["final_checkpoint", "metrics.jsonl"]
