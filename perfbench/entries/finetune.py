"""Fine-tuning: the training step that ``run_training`` runs
(``build_train_step`` with ``make_optimizer``'s AdamW and schedule), fed by
the program's ``DataLoader`` and ``collate`` from labelled files written at
set-up. Set-up builds the one step object and drives it through its first
steps, which the reference follows; the window then runs the same object.
End-to-end: ``train_audio_s_per_s``, the clip seconds trained (batch x clip
x steps) over the window, which ends in a synchronize."""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

from .. import check, program, traffic, weights as wt
from ..common import program_config
from ..reference import frontend as rf
from ..reference import model as rm
from ..reference import targets as rt

FIRST_STEPS = 3


def _dataset_class():
    from whisperseg_torch.data import VocalSegDataset

    class Recording(VocalSegDataset):
        """Keeps, beside each collated batch, what it was made of: each
        item's index, crop and targets."""

        def __getitem__(self, idx, rng=None):
            item = super().__getitem__(idx, rng=rng)
            item["bench_index"] = int(idx)
            return item

        def collate(self, items):
            batch = super().collate(items)
            batch["bench_items"] = [
                {"index": it["bench_index"], "crop": it["audio_clip"],
                 "inputs": it["decoder_input_ids"], "labels": it["labels"]}
                for it in items]
            return batch

    return Recording


def batches(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


def build(ctx, folder: str, step_wrapper=None):
    """The program's data path and training step on the cell's files:
    (params, step, loader, optimizer, file order)."""
    import torch
    from whisperseg_torch import data as wd
    from whisperseg_torch.training import trainer as tr

    model, mix, device = ctx.cell.model, ctx.cell.mix, ctx.device
    cols = model["total_spec_columns"]
    audio_paths, label_paths = wd.get_audio_and_label_paths(folder)
    default = wd.resolve_default_config(audio_paths, label_paths, cols)
    codebook = wd.get_cluster_codebook(label_paths, {})
    audio_list, label_list = wd.load_data(audio_paths, label_paths, codebook,
                                          n_threads=4, default_config=default)
    audio_list, label_list = wd.slice_audios_and_labels(audio_list, label_list,
                                                        cols)
    dataset = _dataset_class()(audio_list, label_list, mix["max_length"], cols,
                               device=device)
    loader = wd.DataLoader(dataset, mix["batch_size"], shuffle=True,
                           drop_last=True, num_workers=mix["num_workers"])
    flat = wt.random_weights(model, ctx.seed, device, torch.float32)
    params = tr.training_params(wt.tree(flat), device)
    del flat
    optimizer, scheduler, _ = tr.make_optimizer(
        params, mix["learning_rate"], mix["weight_decay"],
        mix["warmup_steps"], mix["total_steps"], "linear", False)
    step = tr.build_train_step(program_config(model), optimizer, scheduler)
    if step_wrapper is not None:
        step = step_wrapper(step)
    return params, step, loader, optimizer, audio_paths


def first_steps(ctx, params, step, feed, optimizer):
    """The first steps through the window's own call and feed: each step's
    loss, the first gradient's norm a leaf (from AdamW's first moment after
    one step), each leaf's change after the last (on the host), and the
    items."""
    import torch
    from whisperseg_torch.training.trainer import batch_to_device

    names = dict(wt.flat(params))
    start = {k: v.detach().clone() for k, v in names.items()}
    beta1 = optimizer.param_groups[0]["betas"][0]
    gen = torch.Generator().manual_seed(traffic.derived(ctx.seed, 6))
    losses, grad, items = [], None, []
    for i in range(FIRST_STEPS):
        batch = next(feed)
        items.append(batch["bench_items"])
        losses.append(float(step(params, batch_to_device(batch, ctx.device),
                                 gen)))
        if i == 0:
            grad = {k: check.norm64(optimizer.state[v]["exp_avg"]) / (1 - beta1)
                    if v in optimizer.state else 0.0 for k, v in names.items()}
    delta = {k: (v.detach() - start[k]).float().cpu() for k, v in names.items()}
    del start
    return {"loss": losses, "grad": grad, "delta": delta}, items, gen


def run(ctx) -> dict:
    from whisperseg_torch.training.trainer import batch_to_device

    model, mix, device = ctx.cell.model, ctx.cell.mix, ctx.device
    folder = tempfile.mkdtemp(prefix="perfbench_finetune_")
    try:
        traffic.write_labelled_files(folder, mix, ctx.seed)
        np.random.seed(traffic.derived(ctx.seed, 5))
        params, step, loader, optimizer, paths = build(
            ctx, folder, step_wrapper=ctx.options.get("step_wrapper"))
        feed = batches(loader)
        prog, items, gen = first_steps(ctx, params, step, feed, optimizer)
        step(params, batch_to_device(next(feed), device), gen)  # a 4th, warm
        program.sync(device)
        setup_s = time.perf_counter() - ctx.t_start

        tracer, traced = ctx.tracer(), None
        steps = 0
        before = program.host_sample()
        start = time.perf_counter()
        while steps == 0 or time.perf_counter() - start < ctx.seconds:
            step(params, batch_to_device(next(feed), device), gen)
            steps += 1
            if tracer is not None and traced is None \
                    and steps >= int(mix["trace_steps"]):
                tracer.stop()
                traced = steps
        program.sync(device)
        wall = time.perf_counter() - start
        ctx.host = program.host_window(before, wall)
        if tracer is not None and traced is None:
            tracer.stop()
            traced = steps
        clip_s = model["total_spec_columns"] * mix["spec_time_step"]
        out = {"e2e": {"train_audio_s_per_s":
                       steps * mix["batch_size"] * clip_s / wall,
                       "setup_s": setup_s},
               "attempted": steps, "failed": 0,
               "memory_peak": program.memory_peak(device), "window_s": wall}
        if tracer is not None:
            from ..roofline import train_step_flops
            out["trace"] = tracer
            out["work"] = {"steps": traced, "model_flops": traced * train_step_flops(
                model, model["total_spec_columns"], mix["batch_size"],
                mix["max_length"]), "encoder_batch": mix["batch_size"]}
        del params, step, loader, optimizer, feed
        program.release()
        out["check"] = check_first_steps(ctx, folder, paths, items, prog)
        return out
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def _files(folder_paths, mix, model) -> dict:
    """Each file's training windows as the reference cuts them, from the
    WAV samples and the JSON label."""
    out = {}
    for path in folder_paths:
        import wave
        with wave.open(path, "rb") as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        with open(os.path.splitext(path)[0] + ".json") as f:
            label = json.load(f)
        audio = rf.pcm16_to_float(pcm)
        out[path] = {"windows": rt.windows(audio, label["onset"],
                                           label["offset"], label["sr"],
                                           label["spec_time_step"],
                                           model["total_spec_columns"]),
                     "sr": label["sr"], "step": label["spec_time_step"],
                     "min_frequency": label["min_frequency"]}
    return out


def check_first_steps(ctx, folder, paths, items, prog) -> dict:
    """The reference's first steps on the same items, and the numbers that
    compare the program's with them."""
    model, mix, device = ctx.cell.model, ctx.cell.mix, ctx.device
    files = _files(paths, mix, model)
    where = [(p, j) for p in paths for j in range(len(files[p]["windows"]))]
    ref_batches, differ = [], 0
    for batch_items in items:
        located = []
        for it in batch_items:
            if it["index"] >= len(where):
                return {"label_ids_differ": float("inf")}
            path, j = where[it["index"]]
            located.append({"file": path, "window": j, "crop": it["crop"]})
        rb = check.training_batch(files, located, model, mix["max_length"])
        for it, inp, lab in zip(batch_items, rb["inputs"], rb["labels"]):
            differ += int((np.asarray(it["inputs"]) != inp).sum()
                          + (np.asarray(it["labels"]) != lab).sum())
        ref_batches.append(rb)
    import torch
    weights = {k: v.float() for k, v in wt.random_weights(
        model, ctx.seed, device, torch.float32).items()}
    ref = check.reference_training(
        weights, model, ref_batches,
        lambda i: rm.linear_warmup(i, mix["learning_rate"],
                                   mix["warmup_steps"], mix["total_steps"]),
        device, mix["weight_decay"])
    numbers = check.train_numbers(prog, ref)
    del prog
    numbers["label_ids_differ"] = float(differ)
    if ctx.options.get("control"):
        with rm.lower_precision():
            low = check.reference_training(
                weights, model, ref_batches,
                lambda i: rm.linear_warmup(i, mix["learning_rate"],
                                           mix["warmup_steps"],
                                           mix["total_steps"]),
                device, mix["weight_decay"])
        numbers.update({"control_" + k: v for k, v in
                        check.train_numbers(low, ref).items()})
    return numbers
