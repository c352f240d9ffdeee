"""Whole runs of every cell on the CPU at a tiny size (the run's look for
a card skipped): sound runs come out correct, and a run with the timed
path broken underneath comes out not correct, once for each fault the cell
can have. A card-marked test reads the control on the card at the cell's
own size, where it must come out not correct."""

import contextlib
import copy

import pytest
import torch

from perfbench import calibrate, common, faults, run

TINY_RANDOM = {"d_model": 128, "encoder_layers": 2, "decoder_layers": 2,
               "encoder_attention_heads": 2, "decoder_attention_heads": 2,
               "encoder_ffn_dim": 256, "decoder_ffn_dim": 256}
TINY_CHECKPOINT = {"checkpoint": "pretrained/whisperseg-tiny-animal-vad",
                   "d_model": 384, "encoder_layers": 4, "decoder_layers": 4,
                   "encoder_attention_heads": 6, "decoder_attention_heads": 6,
                   "encoder_ffn_dim": 1536, "decoder_ffn_dim": 1536}
SMALL = {"recording_s": 5.0, "pool": 2, "batch_size": 4, "check_windows": 6,
         "check_recordings": 2, "files": 3, "file_s": 6.0}
CELLS = ["large.segment", "base.frames", "large.finetune"]
FAULTS = {"large.segment": ["token"],
          "base.frames": ["frame", "frame_track", "frame_row", "table"],
          "large.finetune": ["half_batch", "frozen_state", "flipped_update"]}


def tiny(name: str) -> common.Cell:
    cell = copy.deepcopy(common.load_cell(name))
    cell.model.update(TINY_CHECKPOINT if cell.model.get("checkpoint")
                      else TINY_RANDOM)
    mix = cell.mix
    mix.update({k: v for k, v in SMALL.items() if k in mix})
    if mix["entry"] == "segment":
        mix["max_length"] = 8
    if mix["entry"] == "finetune":
        mix.update(max_length=20, batch_size=2, num_workers=2)
        # the tiny model's own limits: its small leaves move further under
        # bf16 than the cell's; the cell's limits hold at its own size
        # (set from calibrate.py's readings on the card)
        cell.limits.update(grad_gap=0.03, change_gap=0.05)
    if mix["entry"] == "frames":
        mix["batch_size"] = 2   # two windows a recording: a full batch
    return cell


def drive(name, options=None, patch=None, seed=2 ** 35 + 9):
    args = run.parse(["--workload", name, "--seed", str(seed),
                      "--seconds", "1"])
    with patch() if patch else contextlib.nullcontext():
        return run.execute(args, tiny(name), torch.device("cpu"), options)[0]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = drive(name)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "compared"      # last key of the line
    e2e = {m["name"] for m in tiny(name).end_to_end}
    assert set(result["metrics"]) == e2e


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in FAULTS[n]])
def test_a_broken_timed_path_is_not_correct(name, fault):
    if fault in faults.TRAINING:
        result = drive(name, {"step_wrapper": faults.TRAINING[fault]})
    else:
        result = drive(name, patch=faults.SERVING[fault])
    assert not result["correct"], result["compared"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(card, name):
    """The control at the cell's own size on three seeds: the program's own
    lower-precision path where the mix names one, else the reference in
    float8. Each reading fails at least one of the cell's limits."""
    cell = common.load_cell(name)
    for seed in (4_100_000_001, 4_100_000_002, 4_100_000_003):
        if "control" in cell.mix:
            read = calibrate.one(cell, seed, 5, card,
                                 {"program_control": cell.mix["control"]})
        else:
            numbers = calibrate.one(cell, seed, 5, card, calibrate.PROGRAM)
            read = {k[len("control_"):]: v for k, v in numbers.items()
                    if k.startswith("control_")}
        compared = common.judge(read, {k: v for k, v in cell.limits.items()
                                       if k in read})
        assert compared and not common.passed(compared), (seed, compared)
