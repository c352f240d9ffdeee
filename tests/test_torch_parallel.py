"""The port's multi-device layouts (whisperseg_torch/parallel/,
training/trainer.py, Segmenter(mesh=...)) against the JAX package's and
against one process.

Two-rank steps run over gloo on the CPU in separate processes
(``tests/torch_parallel_worker.py``, a free port from binding port 0, a
120 s join timeout that kills them), at float32 on the training tests'
model (2+2 layers, d_model 128, 2 heads of 64, 200 spectrogram columns),
global batch 4, two steps at lr 1e-4 (the weights move by 1.4e-4 to
1.5e-4, root mean square, so the parameters' 1e-5 is a tenth of a move):
dp 2, tp 2 and dp 2 with fsdp under AdamW, fsdp and tp under adafactor, and
tp under QAT 8 and 4. Each is held to one process by its losses, its first
step's whole gradients (AdamW and Adafactor hide a gradient's scale; the
gradients do not) and its parameters' change. The global batch's halves
carry different numbers of label tokens, so the mean over the global batch
is what is held."""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_kernel_path import jax_kernel_path
from whisperseg_tpu.models import whisper as jw
from whisperseg_tpu.models.config import WhisperConfig as JaxConfig
from whisperseg_tpu.parallel import mesh as jmesh
from whisperseg_tpu.segmenter import Segmenter as JaxSegmenter
from whisperseg_tpu.training import trainer as jt
from whisperseg_torch.audio.frontend import Frontend
from whisperseg_torch.checkpoint import (_flatten, load_checkpoint,
                                         params_from_numpy, save_checkpoint)
from whisperseg_torch.models.config import WhisperConfig
from whisperseg_torch.parallel import make_mesh, mesh as tmesh, multihost
from whisperseg_torch.parallel.multihost import free_port
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import tone_bursts, write_tone_dataset
from whisperseg_torch.training import trainer as tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
CFG = dict(d_model=128, encoder_layers=2, decoder_layers=2, num_heads=2,
           d_ff=256, max_source_positions=100, max_target_positions=64,
           total_spec_columns=200, compute_dtype="float32")
B, L, STEPS, LR = 4, 24, 2, 1e-4
CASES = {
    "dp2": dict(tp=1, fsdp=False, optimizer="adamw", qat=0),
    "tp2": dict(tp=2, fsdp=False, optimizer="adamw", qat=0),
    "dp2_fsdp": dict(tp=1, fsdp=True, optimizer="adamw", qat=0),
    "dp2_fsdp_adafactor": dict(tp=1, fsdp=True, optimizer="adafactor", qat=0),
    "tp2_adafactor": dict(tp=2, fsdp=False, optimizer="adafactor", qat=0),
    # o/fc2/xo are cut on their contraction dim: their int8 scales and
    # int4 groups (128 rows: the whole 128-wide input) span both ranks
    "tp2_qat8": dict(tp=2, fsdp=False, optimizer="adamw", qat=8),
    "tp2_qat4": dict(tp=2, fsdp=False, optimizer="adamw", qat=4),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port on one torch thread, as its ranks are (beside the other
    test processes, more threads would contend for the same cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_ranks(cmds, timeout=120, env=None):
    """Start each command in its own session; kill them all if any is still
    running after ``timeout`` s."""
    procs = [subprocess.Popen(c, cwd=ROOT, start_new_session=True, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _batch(seed):
    """A global batch of 4 whose second half carries far fewer label
    tokens than its first."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, size=(B, L)).astype(np.int32)
    labels = rng.randint(0, 1024, size=(B, L)).astype(np.int32)
    ids[3, 18:] = 10
    labels[2:, 6:] = -100
    labels[0, :6] = rng.randint(23, 1024, size=6)
    return {"input_features": rng.uniform(-1.0, 1.5, (B, 80, 200)).astype(
        np.float32), "decoder_input_ids": ids, "labels": labels}


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = JaxConfig(**CFG), WhisperConfig(**CFG)
    np_params = jax.tree.map(lambda x: np.array(x, np.float32),
                             jw.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, np_params, [_batch(s) for s in range(STEPS)]


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    _, cfg, np_params, batches = setup
    out = str(tmp_path_factory.mktemp("ranks"))
    arrays = {"p." + k: v for k, v in _flatten(np_params).items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}.{k}": v for k, v in b.items()})
    np.savez(os.path.join(out, "setup.npz"), **arrays)
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump({"cfg": CFG, "steps": STEPS, "batch": B, "lr": LR,
                   "cases": CASES}, f)
    port = str(free_port())
    _run_ranks([[sys.executable, WORKER, str(r), "2", port, out]
                for r in range(2)])
    return {name: dict(np.load(os.path.join(out, f"{name}.npz")))
            for name in CASES}


def _single(cfg, np_params, batches, optimizer, qat):
    """The single-process port's losses, first step's gradients and
    parameters."""
    params = tt.training_params(params_from_numpy(np_params, cfg, "cpu"), "cpu")
    opt, sched, _ = tt.make_optimizer(params, LR, 0.01, 0, 10, "linear", False,
                                      optimizer=optimizer)
    step = tt.build_train_step(cfg, opt, sched, qat_bits=qat)
    losses, grads = [], None
    for b in batches:
        losses.append(float(step(params, tt.batch_to_device(dict(
            b, input_features=torch.from_numpy(b["input_features"])), "cpu"),
            torch.Generator())))
        if grads is None:
            grads = {k: v.grad.numpy().copy()
                     for k, v in _flatten(params).items()}
    return (losses, grads,
            {k: v.detach().numpy() for k, v in _flatten(params).items()})


@pytest.fixture(scope="module")
def single(setup):
    _, cfg, np_params, batches = setup
    return {(c["optimizer"], c["qat"]): _single(cfg, np_params, batches,
                                                c["optimizer"], c["qat"])
            for c in CASES.values()}


@pytest.fixture(scope="module")
def jax_loss(setup):
    """JAX's single-device build_train_step loss on the first batch, for
    each QAT setting of the cases."""
    jcfg, _, np_params, batches = setup
    out = {}
    with jax_kernel_path():
        for qat in sorted({c["qat"] for c in CASES.values()}):
            jparams = jax.tree.map(jnp.asarray, np_params)  # donated
            opt, _ = jt.make_optimizer(jparams, LR, 0.01, 0, 10, "linear",
                                       False)
            step = jt.build_train_step(jcfg, opt, qat_bits=qat)
            _, _, loss = step(jparams, opt.init(jparams),
                              jax.tree.map(jnp.asarray, batches[0]),
                              jax.random.PRNGKey(1))
            out[qat] = float(loss)
    return out


def test_the_halves_of_the_batch_weigh_differently(setup):
    for b in setup[3]:
        n = (b["labels"] != -100).sum(axis=1)
        assert n[:2].sum() > 3 * n[2:].sum()


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_rank_steps_match_one_process(case, setup, two_ranks, single,
                                         jax_loss):
    got, c = two_ranks[case], CASES[case]
    want_losses, want_grads, want_params = single[c["optimizer"], c["qat"]]
    jloss = jax_loss[c["qat"]]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-6, atol=0)
    assert abs(want_losses[0] - jloss) <= 1e-5 * abs(jloss)
    assert abs(got["losses"][0] - jloss) <= 1e-5 * abs(jloss)
    # the global batch's gradient: a sum missed, halved or doubled fails
    for k, w in want_grads.items():
        np.testing.assert_allclose(got["g." + k], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    init = _flatten(setup[2])
    num = den = 0.0
    for k, w in want_params.items():
        np.testing.assert_allclose(got["p." + k], w, rtol=0, atol=1e-5,
                                   err_msg=k)
        num += float(((got["p." + k] - w).astype(np.float64) ** 2).sum())
        den += float(((w - init[k]).astype(np.float64) ** 2).sum())
    # the weights moved by about the learning rate; the layouts' changes
    # agree with one process's to 1e-4 of their norm
    assert np.sqrt(den / sum(v.size for v in init.values())) > 0.5 * LR
    assert np.sqrt(num / den) < 1e-4


@pytest.mark.parametrize("tp,fsdp,data_size", [
    (True, False, 0), (False, True, 0), (True, True, 2), (False, True, 3),
    (False, False, 0)])
def test_param_pspecs_equal_jax(setup, tp, fsdp, data_size):
    jcfg, cfg, np_params, _ = setup
    cfg = WhisperConfig(**dict(CFG, frame_head=True, frame_head_clusters=2,
                               d_ff=384))
    jcfg = JaxConfig(**dict(CFG, frame_head=True, frame_head_clusters=2,
                            d_ff=384))
    np_params = jax.tree.map(lambda x: np.array(x, np.float32),
                             jw.init_params(jax.random.PRNGKey(0), jcfg))
    want = jmesh.param_pspecs(np_params, jcfg, tp=tp, fsdp=fsdp,
                              data_size=data_size)
    got = tmesh.param_pspecs(params_from_numpy(np_params, cfg, "cpu"), cfg,
                             tp=tp, fsdp=fsdp, data_size=data_size)
    flat_want = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert len(flat_want) == len(_flatten(got))
    for path, spec in flat_want:
        name = ".".join(p.key for p in path)
        assert _flatten(got)[name] == tuple(spec), name


def test_mesh_and_batch_slices():
    mesh = make_mesh(devices=["cpu"] * 4, tp=2)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert [mesh.coords(r) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    assert tmesh.batch_sharding(mesh).spec == ("data",)
    assert tmesh.replicated(mesh).spec == ()
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(devices=["cpu"] * 3, tp=2)
    # one process: the whole batch, and initialize() does nothing
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        assert var not in os.environ
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost.per_host_batch_slice(8) == slice(0, 8)
    leaf = torch.arange(24.0).reshape(2, 3, 4)
    part = tmesh.local_part(leaf, (None, None, "model"), mesh, 3)
    assert torch.equal(part, leaf[:, :, 2:])
    part = tmesh.local_part(leaf, ("data", None, None), mesh, 2)
    assert torch.equal(part, leaf[1:])


def test_per_host_batch_slice_and_initialize_in_a_group(tmp_path):
    code = (
        "import sys, torch.distributed as dist\n"
        "from whisperseg_torch.parallel import multihost\n"
        "r = int(sys.argv[1])\n"
        "multihost.initialize(f'127.0.0.1:{sys.argv[2]}', 2, r)\n"
        "assert dist.get_backend() == 'gloo'\n"
        "assert multihost.per_host_batch_slice(6) == slice(3 * r, 3 * r + 3)\n"
        "try:\n"
        "    multihost.per_host_batch_slice(5)\n"
        "except ValueError as e:\n"
        "    assert 'not divisible' in str(e)\n"
        "else:\n"
        "    raise AssertionError('no ValueError')\n"
        "multihost.initialize(f'127.0.0.1:{sys.argv[2]}', 2, r)  # kept\n"
        "import torch\n"
        "from whisperseg_torch.parallel import make_mesh, shard_params\n"
        "from whisperseg_torch.models.config import WhisperConfig\n"
        "cfg = WhisperConfig(d_model=8, num_heads=2, d_ff=16)\n"
        "p = {'decoder': {'layers': {'q_w': torch.arange(128.).reshape(2, 8, 8),\n"
        "                            'o_w': torch.arange(128.).reshape(2, 8, 8),\n"
        "                            'ln1_g': torch.ones(2, 8)}}}\n"
        "mesh = make_mesh(devices=['cpu', 'cpu'], tp=2)\n"
        "part = shard_params(mesh, p, cfg, tp=True)['decoder']['layers']\n"
        "full = p['decoder']['layers']\n"
        "assert torch.equal(part['q_w'], full['q_w'][:, :, 4 * r:4 * r + 4])\n"
        "assert torch.equal(part['o_w'], full['o_w'][:, 4 * r:4 * r + 4])\n"
        "assert torch.equal(part['ln1_g'], full['ln1_g'])\n"
        "part = shard_params(make_mesh(devices=['cpu', 'cpu']), p, cfg,\n"
        "                    fsdp=True)['decoder']['layers']\n"
        "assert torch.equal(part['ln1_g'], full['ln1_g'][:, 4 * r:4 * r + 4])\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n")
    port = str(free_port())
    outs = _run_ranks([[sys.executable, "-c", code, str(r), port]
                       for r in range(2)])
    assert all(o.strip().endswith("ok") for o in outs)


RUN = dict(max_num_iterations=3, batch_size=4, max_length=24,
           total_spec_columns=200, learning_rate=1e-3, warmup_steps=1,
           print_every=1, num_workers=1, seed=5)


def test_run_training_on_two_cpu_ranks_matches_one_process(setup, tmp_path):
    _, cfg, np_params, _ = setup
    data = write_tone_dataset(str(tmp_path / "data"), 4, duration=2.5)
    init = str(tmp_path / "init")
    save_checkpoint(init, params_from_numpy(np_params, cfg, "cpu"), cfg)
    one = str(tmp_path / "one")
    tt.run_training(tt.TrainArgs(initial_model_path=init, model_folder=one,
                                 train_dataset_folder=data, device="cpu",
                                 **RUN))
    two = str(tmp_path / "two")
    code = (
        "import sys\n"
        "from whisperseg_torch.training import trainer as tt\n"
        f"out = tt.run_training(tt.TrainArgs(initial_model_path={init!r}, "
        f"model_folder={two!r}, train_dataset_folder={data!r}, "
        f"device='cpu', n_device=2, **{RUN!r}))\n"
        "print('final', out)\n")
    # one torch thread a rank (the spawned ranks inherit it)
    out = _run_ranks([[sys.executable, "-c", code]],
                     env=dict(os.environ, OMP_NUM_THREADS="1"))[0]
    assert "final " + os.path.join(two, "final_checkpoint") in out
    assert "Rank 1/2: dp=2, tp=1, fsdp=False, backend=gloo" in out

    def losses(folder):
        with open(os.path.join(folder, "metrics.jsonl")) as f:
            return [json.loads(line)["train/loss"] for line in f]

    assert len(losses(one)) == 3
    np.testing.assert_allclose(losses(two), losses(one), rtol=1e-6)
    p1, _ = load_checkpoint(os.path.join(one, "final_checkpoint"))
    p2, _ = load_checkpoint(os.path.join(two, "final_checkpoint"))
    for k, v in _flatten(p1).items():
        np.testing.assert_allclose(_flatten(p2)[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_more_cuda_ranks_than_cards_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = tt.TrainArgs(initial_model_path="tiny", device="cuda", n_device=2,
                        model_folder=str(tmp_path))
    with pytest.raises(ValueError, match="2 CUDA ranks"):
        tt.run_training(args)
    # the device pool stays single-device, as in the JAX package
    args = tt.TrainArgs(initial_model_path="tiny", device="cpu", n_device=2,
                        device_pool=True, model_folder=str(tmp_path))
    with pytest.raises(ValueError, match="device_pool supports single"):
        tt.run_training(args)


@pytest.fixture(scope="module")
def mesh_segmenters():
    params, cfg = load_checkpoint(TINY)
    cfg.compute_dtype = "float32"
    plain = Segmenter(params, cfg, inference_dtype="float32", device="cpu")
    cpu = torch.device("cpu")
    meshed = Segmenter(params, cfg, inference_dtype="float32",
                       mesh=make_mesh(devices=[cpu, cpu]))
    return plain, meshed


REQUEST = dict(sr=32000, num_trials=1, batch_size=2)


def test_mesh_segmenter_tables_equal_plain_and_jax_mesh(mesh_segmenters):
    from whisperseg_tpu.checkpoint import load_checkpoint as jax_load

    plain, meshed = mesh_segmenters
    audio = tone_bursts(3, sr=32000, duration=7.0)
    kw = dict(num_beams=1, **REQUEST)
    want = plain.segment(audio, **kw)
    assert meshed.segment(audio, **kw) == want
    assert len(want["onset"]) >= 3
    jparams, jcfg = jax_load(TINY)
    jcfg.compute_dtype = "float32"
    jseg = JaxSegmenter(jparams, jcfg, inference_dtype="float32",
                        mesh=jmesh.make_mesh(2))
    assert json.loads(json.dumps(jseg.segment(audio, **kw))) == want
    # sampling: the noise of the whole batch, cut by rows
    kw = dict(num_beams=1, top_k=3, seed=4, **REQUEST)
    assert meshed.segment(audio, **kw) == plain.segment(audio, **kw)
    dsc = plain.default_segmentation_config
    clips, _ = plain.slice_audio_windows(audio, 32000, dsc["spec_time_step"], 1)
    frontend = Frontend(32000, dsc["spec_time_step"], dsc["min_frequency"])
    with pytest.raises(ValueError, match="does not divide"):
        meshed._generate_tokens(clips, frontend, 3, 24, 1, 1.0)
