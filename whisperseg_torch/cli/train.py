"""Training CLI (the port of ``whisperseg_tpu/cli/train.py``: the same
flags, plus ``--device``).

    python -m whisperseg_torch.cli.train --initial_model_path DIR \
        --model_folder OUT --train_dataset_folder DATA

Several devices: ``--n_device N`` (one process a device, started by the
run: ``cuda:0`` .. ``cuda:N-1``, or CPU ranks under ``--device cpu``),
``--tp`` (tensor parallelism) and ``--fsdp 1`` (sharded parameters). A
process group started otherwise (``torchrun`` running a script that calls
``parallel.multihost.initialize()`` and then ``run_training``) is trained
over as it is. ``--use_wandb`` raises ``NotImplementedError`` (the package
is absent).
"""

from __future__ import annotations

import argparse

from ..training import TrainArgs, run_training


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--initial_model_path", required=True,
                   help="checkpoint dir (params.npz, or a HuggingFace "
                        "Whisper directory) or a size name tiny/base/small/"
                        "medium/large")
    p.add_argument("--model_folder", required=True)
    p.add_argument("--train_dataset_folder", required=True)
    p.add_argument("--n_device", type=int, default=None,
                   help="devices to train on (default: every CUDA "
                        "device; 1 on the CPU)")
    p.add_argument("--gpu_list", type=int, nargs="+", default=None,
                   help="accepted for compat; device selection is automatic")
    p.add_argument("--use_wandb", type=int, default=0)
    p.add_argument("--project", default="whisperseg-tpu")
    p.add_argument("--run_name", default=None)
    p.add_argument("--print_every", type=int, default=100)
    p.add_argument("--validate_every", type=int, default=None)
    p.add_argument("--validate_per_epoch", type=int, default=0)
    p.add_argument("--save_every", type=int, default=None)
    p.add_argument("--save_per_epoch", type=int, default=0)
    p.add_argument("--max_num_epochs", type=int, default=3)
    p.add_argument("--max_num_iterations", type=int, default=None)
    p.add_argument("--min_num_iterations", type=int, default=500)
    p.add_argument("--val_ratio", type=float, default=0.0)
    p.add_argument("--max_length", type=int, default=100)
    p.add_argument("--total_spec_columns", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=3e-6)
    p.add_argument("--lr_schedule", default="linear")
    p.add_argument("--max_to_keep", type=int, default=-1)
    p.add_argument("--seed", type=int, default=66100)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--freeze_encoder", type=int, default=0)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "adafactor"],
                   help="adafactor: factored second moments, almost no "
                        "optimizer state")
    p.add_argument("--qat_bits", type=int, default=0, choices=[0, 4, 8],
                   help="quantization-aware training: projection weights on "
                        "their int8 / int4 grid in the forward, float32 "
                        "master weights (straight-through gradient)")
    p.add_argument("--timestamp_loss_weight", type=float, default=1.0,
                   help=">1 upweights timestamp-token targets in the loss "
                        "(boundary-accuracy lever; segment F1)")
    p.add_argument("--timestamp_label_sigma", type=float, default=0.0,
                   help=">0: replace one-hot timestamp targets with a "
                        "discrete Gaussian over neighboring columns (stddev "
                        "in columns) — distance-aware boundary loss")
    p.add_argument("--frame_head", type=int, default=1,
                   help="train the auxiliary encoder frame head (per-timestamp-"
                        "quantum vocal/onset/offset/cluster logits) jointly "
                        "with the seq2seq loss; enables learned boundary "
                        "refinement and the decoder-free frame-VAD mode. "
                        "ON by default; pass 0 for a reference-exact model")
    p.add_argument("--frame_head_weight", type=float, default=1.0,
                   help="frame-head loss weight relative to the token CE")
    p.add_argument("--frame_boundary_weight", type=float, default=1.0,
                   help="onset/offset (cut) channel loss weight relative to "
                        "the vocal channel — upweight (e.g. 4) to sharpen "
                        "sub-call boundary learning on densely annotated "
                        "corpora (the meerkat merged-sub-call failure mode)")
    p.add_argument("--frame_label_sigma", type=float, default=1.0,
                   help="Gaussian stddev (grid positions) of the soft "
                        "onset/offset event targets for the frame head")
    p.add_argument("--synth_augment", type=int, default=0,
                   help="add N splice-synthesized training files built from "
                        "the training split's syllables and noise beds")
    p.add_argument("--spec_augment", type=int, default=0,
                   help="SpecAugment frequency/time masking on the training "
                        "features (regularizer for small datasets)")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--clear_cluster_codebook", type=int, default=1)
    p.add_argument("--ignore_cluster", type=int, default=0)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width over the device mesh")
    p.add_argument("--fsdp", type=int, default=0,
                   help="shard the parameters over the data axis")
    p.add_argument("--remat", type=int, default=0,
                   help="recompute each layer's activations in the backward "
                        "(less device memory, more work)")
    p.add_argument("--device_pool", type=int, default=0,
                   help="epoch blocks of crops held on the device, each "
                        "trained in one call with on-device batch gathers")
    p.add_argument("--gqa_kv_heads", type=int, default=0,
                   help="convert the initial model to this many K/V heads "
                        "(mean-pooled groups), then train")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of steps 10-14 here")
    p.add_argument("--device", default=None,
                   help="torch device to train on; the CUDA card unless "
                        "'cpu' is given")
    return p


def main(argv=None):
    a = build_parser().parse_args(argv)
    args = TrainArgs(
        initial_model_path=a.initial_model_path,
        model_folder=a.model_folder,
        train_dataset_folder=a.train_dataset_folder,
        n_device=a.n_device,
        print_every=a.print_every,
        validate_every=a.validate_every,
        validate_per_epoch=bool(a.validate_per_epoch),
        save_every=a.save_every,
        save_per_epoch=bool(a.save_per_epoch),
        max_num_epochs=a.max_num_epochs,
        max_num_iterations=a.max_num_iterations,
        min_num_iterations=a.min_num_iterations,
        val_ratio=a.val_ratio,
        max_length=a.max_length,
        total_spec_columns=a.total_spec_columns,
        batch_size=a.batch_size,
        learning_rate=a.learning_rate,
        lr_schedule=a.lr_schedule,
        max_to_keep=a.max_to_keep,
        seed=a.seed,
        weight_decay=a.weight_decay,
        warmup_steps=a.warmup_steps,
        freeze_encoder=bool(a.freeze_encoder),
        optimizer=a.optimizer,
        qat_bits=a.qat_bits,
        timestamp_loss_weight=a.timestamp_loss_weight,
        timestamp_label_sigma=a.timestamp_label_sigma,
        frame_head=bool(a.frame_head),
        frame_head_weight=a.frame_head_weight,
        frame_boundary_weight=a.frame_boundary_weight,
        frame_label_sigma=a.frame_label_sigma,
        synth_augment=a.synth_augment,
        spec_augment=bool(a.spec_augment),
        dropout=a.dropout,
        num_workers=a.num_workers,
        clear_cluster_codebook=bool(a.clear_cluster_codebook),
        ignore_cluster=bool(a.ignore_cluster),
        tp=a.tp,
        fsdp=bool(a.fsdp),
        remat=bool(a.remat),
        device_pool=bool(a.device_pool),
        gqa_kv_heads=a.gqa_kv_heads,
        project=a.project,
        run_name=a.run_name,
        use_wandb=bool(a.use_wandb),
        profile_dir=a.profile_dir,
        device=a.device,
    )
    run_training(args)


if __name__ == "__main__":
    main()
