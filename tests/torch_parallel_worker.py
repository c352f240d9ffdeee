"""One rank of the two-rank training steps of test_torch_parallel.py.

    python tests/torch_parallel_worker.py RANK WORLD PORT DIR

Joins a gloo process group on 127.0.0.1:PORT, reads ``DIR/setup.npz`` (the
initial parameters, flat, and the global batches) and ``DIR/cases.json``,
and for each case trains its steps on this rank's rows and parts
(``build_train_step(..., parallel=...)``). Rank 0 writes each case's losses
(the ranks' shares summed), its first step's whole gradients and its whole
parameters to ``DIR/<case>.npz``."""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from whisperseg_torch.checkpoint import _flatten, _unflatten  # noqa: E402
from whisperseg_torch.models.config import WhisperConfig  # noqa: E402
from whisperseg_torch.parallel import mesh as pmesh  # noqa: E402
from whisperseg_torch.training import trainer as tt  # noqa: E402


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(os.path.join(out, "cases.json")) as f:
        spec = json.load(f)
    cfg = WhisperConfig(**spec["cfg"])
    with np.load(os.path.join(out, "setup.npz")) as z:
        flat = {k[2:]: torch.from_numpy(z[k]) for k in z.files
                if k.startswith("p.")}
        batches = [{k.split(".", 1)[1]: z[k] for k in z.files
                    if k.startswith(f"b{i}.")} for i in range(spec["steps"])]
    for name, case in spec["cases"].items():
        args = tt.TrainArgs(tp=case["tp"], fsdp=case["fsdp"],
                            batch_size=spec["batch"])
        dp = world // case["tp"]
        full = _unflatten({k: v.clone() for k, v in flat.items()})
        par = tt._parallel_layout(args, torch.device("cpu"), full, cfg, dp)
        params = tt.training_params(pmesh.shard_params(
            par.mesh, full, cfg, tp=case["tp"] > 1, fsdp=case["fsdp"]), "cpu")
        opt, sched, _ = tt.make_optimizer(
            params, spec["lr"], 0.01, 0, 10, "linear", False,
            optimizer=case["optimizer"], shards=par.shards(params))
        step = tt.build_train_step(cfg, opt, sched, qat_bits=case["qat"],
                                   parallel=par)
        losses, grads = [], None
        for batch in batches:
            rows = par.rows(tt.batch_to_device(dict(
                batch, input_features=torch.from_numpy(
                    batch["input_features"])), "cpu"))
            losses.append(float(par.sum_data(step(params, rows,
                                                  torch.Generator()))))
            if grads is None:  # the first step's gradients, whole
                grads = par.full(pmesh.tree_map(params, lambda p: p.grad))
        whole = {k: v.numpy() for k, v in _flatten(par.full(params)).items()}
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.npz"),
                     losses=np.asarray(losses, np.float64),
                     **{"p." + k: v for k, v in whole.items()},
                     **{"g." + k: v.numpy()
                        for k, v in _flatten(grads).items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
