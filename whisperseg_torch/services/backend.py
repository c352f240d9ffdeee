r"""Model-zoo and training-queue backend service (the port of
``whisperseg_tpu/services/backend.py``, itself a port of the reference's
scripts/backend.py).

    python -m whisperseg_torch.services.backend \
        --dataset_base_folder data --model_base_folder models --port 8060

The registry holds the built-in models (``pretrained/``) and every
``<model_base_folder>/<name>/final_checkpoint``, sorted by ctime and
refreshed once a second by a daemon thread; one checkpoint serves both
inference and fine-tuning. Endpoints: GET /status; POST
/list-models-available-for-finetuning | -for-inference |
/list-models-training-in-progress | /list-all-models |
/get-training-request-queue | /submit-training-request (multipart zip) |
/segment (multipart audio).

Training requests run one at a time, each in a subprocess:
``python -m whisperseg_torch.cli.train`` (or the ``train_script`` given), with
``--device`` passed on when the backend was given one. Queued requests are
journalled in ``<model_base_folder>/training_queue.json`` and survive a
restart. Segmenters are cached, least used first out, up to
``max_num_segmenters_in_ram``.

``/segment`` answers an empty table with 400 for a request it cannot serve
(no ``audio_file``, a model that is unknown or not ready, audio that cannot
be decoded); whatever the segmenter raises is not caught and answers 500,
so that a fault on the device is never reported as an empty table. The JAX
backend answers 400 for both.

The service runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback
import zipfile
from pathlib import Path
from typing import Dict, List, Optional

from .http_util import JsonHTTPServer, Request
from .post_process import PROCESS_TOOLBOX

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class BackendState:
    def __init__(self, dataset_base_folder: str, model_base_folder: str,
                 max_num_segmenters_in_ram: int = 1,
                 pretrained_models: Optional[List[dict]] = None,
                 train_script: Optional[str] = None,
                 inference_dtype: str = "bfloat16",
                 training_timeout: Optional[float] = None,
                 device=None):
        from ..runtime import resolve_device

        self.dataset_base_folder = dataset_base_folder
        self.model_base_folder = model_base_folder
        self.max_num_segmenters_in_ram = max_num_segmenters_in_ram
        self.inference_dtype = inference_dtype
        self.training_timeout = training_timeout
        self.pretrained_models = pretrained_models or []
        self.train_script = train_script
        # the card unless the CPU is asked for; the training subprocess gets
        # --device only when the caller named one
        self.device = resolve_device(device)
        self.train_device = None if device is None else str(device)
        self.training_request_queue: List[dict] = []
        # one entry a finished or failed training run: model_name,
        # exit_code (None when it never ended) and seconds
        self.training_log: List[dict] = []
        self.sem = threading.Semaphore()
        self.queue_lock = threading.Lock()
        self.running_segmenters: Dict[str, dict] = {}
        self.model_information = {"all_models": []}
        self.training_active = False
        os.makedirs(dataset_base_folder, exist_ok=True)
        os.makedirs(model_base_folder, exist_ok=True)
        self._journal_path = os.path.join(model_base_folder,
                                          "training_queue.json")
        self._load_queue_journal()

    # -------------------------------------------------------- queue journal
    #
    # Queued training requests survive a backend restart (the reference keeps
    # the queue in memory only). A request that was mid-training restarts
    # from "queuing".

    def _save_queue_journal(self):
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.training_request_queue, f)
        os.replace(tmp, self._journal_path)

    def _load_queue_journal(self):
        try:
            with open(self._journal_path) as f:
                entries = json.load(f)
        except Exception:
            return
        for item in entries:
            if os.path.isdir(item.get("train_dataset_folder", "")):
                item["status"] = "queuing"
                self.training_request_queue.append(item)

    # ------------------------------------------------------------ registry

    def list_models(self) -> List[dict]:
        """(reference scripts/backend.py:80-125)"""
        all_models = []
        for item in self.pretrained_models:
            all_models.append({
                "model_name": item["model_name"],
                "inference_model_path": item["inference_model_path"],
                "finetune_model_path": item["finetune_model_path"],
                "status": "ready",
            })
        queued_names = [i["model_name"] for i in self.training_request_queue]

        def _ctime(p):
            try:
                return p.stat().st_ctime
            except OSError:  # e.g. the queue journal's .tmp mid-os.replace
                return float("inf")

        candi = [os.path.basename(str(p)) for p in
                 sorted(Path(self.model_base_folder).glob("*"), key=_ctime)]
        for name in candi:
            folder = os.path.join(self.model_base_folder, name)
            if not os.path.isdir(folder) or name in queued_names:
                continue
            final = os.path.join(folder, "final_checkpoint")
            if os.path.exists(final):
                all_models.append({
                    "model_name": name,
                    "inference_model_path": final,
                    "finetune_model_path": final,
                    "status": "ready",
                })
        for item in self.training_request_queue:
            all_models.append({
                "model_name": item["model_name"],
                "inference_model_path": None,
                "finetune_model_path": None,
                "status": item["status"],
            })
        for item in all_models:
            if item["status"] == "training":
                status_file = os.path.join(self.model_base_folder,
                                           item["model_name"], "status.json")
                try:
                    with open(status_file) as f:
                        eta = json.load(f)["eta"]
                    assert re.fullmatch(r"\d+:\d+:\d+", eta)
                except Exception:
                    eta = "--:--:--"
                item["eta"] = eta
        return all_models

    def periodic_list_models(self):
        while True:
            # a stat racing the journal's os.replace raises: the refresher
            # reports it and goes on, or /list-* would freeze
            try:
                self.model_information["all_models"] = self.list_models()
            except Exception as e:
                print(f"list_models refresh failed (retrying): "
                      f"{type(e).__name__}: {e}")
            time.sleep(1)

    # ---------------------------------------------------------- segmenters

    def get_segmenter(self, model_name: str, model_path: str):
        """Least-used-out cache (reference scripts/backend.py:267-277)."""
        from ..segmenter import Segmenter

        if model_name not in self.running_segmenters:
            if len(self.running_segmenters) >= self.max_num_segmenters_in_ram:
                victim = sorted(self.running_segmenters,
                                key=lambda k: self.running_segmenters[k]["usage"])[0]
                del self.running_segmenters[victim]
                gc.collect()
            self.running_segmenters[model_name] = {
                "usage": 0, "segmenter": Segmenter.from_pretrained(
                    model_path, inference_dtype=self.inference_dtype,
                    device=self.device)
            }
        entry = self.running_segmenters[model_name]
        entry["usage"] += 1
        return entry["segmenter"]

    def release_segmenters(self) -> None:
        """Drop every cached segmenter and the memory it held on the card."""
        self.running_segmenters.clear()
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()

    # ------------------------------------------------------- training queue

    def training_command(self, initial_model_path: str, req: dict) -> List[str]:
        """The training subprocess's command line for queue entry ``req``."""
        entry = ([self.train_script] if self.train_script is not None
                 else ["-m", "whisperseg_torch.cli.train"])
        cmd = [
            sys.executable, *entry,
            "--initial_model_path", initial_model_path,
            "--train_dataset_folder", req["train_dataset_folder"] + "/",
            "--model_folder", os.path.join(self.model_base_folder,
                                           req["model_name"]),
            "--max_num_epochs", str(req["num_epochs"]),
            "--ignore_cluster", str(req["ignore_cluster"]),
            # the frame-VAD head; 1 is cli/train.py's default
            "--frame_head", str(req.get("frame_head", 1)),
        ]
        if self.train_device is not None:
            cmd += ["--device", self.train_device]
        return cmd

    def run_training_worker(self):
        """(reference scripts/backend.py:311-350)"""
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p)
        while True:
            if self.training_request_queue:
                print("Start training ...", flush=True)
                try:
                    with self.queue_lock:
                        self.training_request_queue[0]["status"] = "training"
                        self._save_queue_journal()
                    req = self.training_request_queue[0]
                    initial_model_path = None
                    for item in self.list_models():
                        if (item["model_name"] == req["initial_model_name"]
                                and item["finetune_model_path"] is not None
                                and item["status"] == "ready"):
                            initial_model_path = item["finetune_model_path"]
                            break
                    assert initial_model_path is not None
                    self.training_active = True
                    t0 = time.perf_counter()
                    # training_timeout bounds a wedged run so that the queue
                    # never stalls for good; None waits as long as it takes
                    rc = subprocess.run(
                        self.training_command(initial_model_path, req),
                        env=env, timeout=self.training_timeout).returncode
                    self.training_active = False
                    self.training_log.append({
                        "model_name": req["model_name"], "exit_code": rc,
                        "seconds": time.perf_counter() - t0})
                    print(f"Training finished (exit code {rc}).", flush=True)
                    with self.queue_lock:
                        self.training_request_queue.pop(0)
                        self._save_queue_journal()
                except Exception:
                    self.training_active = False
                    self.training_log.append({
                        "model_name": self.training_request_queue[0][
                            "model_name"], "exit_code": None, "seconds": None})
                    print("Training error!", flush=True)
                    traceback.print_exc()
                    with self.queue_lock:
                        self.training_request_queue.pop(0)
                        self._save_queue_journal()
            time.sleep(5)


_EMPTY = {"onset": [], "offset": [], "cluster": []}


def build_app(state: BackendState) -> JsonHTTPServer:
    from ..audio.io import load_audio

    app = JsonHTTPServer()

    @app.route("/status", methods=["GET"])
    def status(req: Request):
        return {"status": "ready"}, 200

    def _model_rows(filter_fn):
        rows = [
            {"model_name": m["model_name"], "status": m["status"],
             "eta": m.get("eta", "--:--:--")}
            for m in state.model_information["all_models"] if filter_fn(m)
        ]
        return {"response": rows}, 200

    @app.route("/list-models-available-for-finetuning", methods=["POST"])
    def list_finetune(req: Request):
        return _model_rows(lambda m: m["finetune_model_path"] is not None
                           and m["status"] == "ready")

    @app.route("/list-models-available-for-inference", methods=["POST"])
    def list_inference(req: Request):
        return _model_rows(lambda m: m["inference_model_path"] is not None
                           and m["status"] == "ready")

    @app.route("/list-models-training-in-progress", methods=["POST"])
    def list_training(req: Request):
        return _model_rows(lambda m: m["status"] != "ready")

    @app.route("/list-all-models", methods=["POST"])
    def list_all(req: Request):
        return _model_rows(lambda m: True)

    @app.route("/get-training-request-queue", methods=["POST"])
    def get_queue(req: Request):
        return {"response": state.training_request_queue}, 200

    @app.route("/submit-training-request", methods=["POST"])
    def submit(req: Request):
        """(reference scripts/backend.py:170-235)"""
        with state.sem:
            model_name = req.form_get("model_name")
            initial_model_name = req.form_get("initial_model_name")
            num_epochs = req.form_get("num_epochs", type=int, default=3)
            ignore_cluster = req.form_get("ignore_cluster", type=int, default=0)
            frame_head = req.form_get("frame_head", type=int, default=1)

            if model_name is None:
                return {"error": "Model name cannot be empty"}, 400
            illegal = sorted(set(re.findall(r"[^a-zA-Z0-9\-\_\.]+", model_name)))
            if illegal:
                return {"error": 'Model name cannot contain special characters '
                                 '"%s"' % " ".join(illegal)}, 400
            model_name = model_name.lower().strip()
            if model_name == "":
                return {"error": "Model name cannot be empty"}, 400

            all_models = state.list_models()
            if model_name in [m["model_name"] for m in all_models]:
                return {"error": "Model name already exists"}, 400

            if initial_model_name is None:
                initial_model_name = "whisperseg-base"
            initial_model_name = initial_model_name.lower().strip()
            finetunable = [m["model_name"] for m in all_models
                           if m["finetune_model_path"] is not None]
            if initial_model_name not in finetunable:
                return {"error": 'initial_model_name is not available for '
                                 'finetuning, call "list-models-available-for-'
                                 'finetuning" API to get the available '
                                 'model_name list'}, 400

            if "zip" not in req.files:
                return {"error": "No training files are provided in the request"}, 400
            dataset_folder = os.path.join(state.dataset_base_folder, model_name)
            os.makedirs(dataset_folder, exist_ok=True)
            with zipfile.ZipFile(io.BytesIO(req.files["zip"])) as zf:
                zf.extractall(dataset_folder)

            with state.queue_lock:
                state.training_request_queue.append({
                    "model_name": model_name,
                    "initial_model_name": initial_model_name,
                    "train_dataset_folder": dataset_folder,
                    "num_epochs": num_epochs,
                    "ignore_cluster": ignore_cluster,
                    "frame_head": frame_head,
                    "status": "queuing",
                })
                state._save_queue_journal()
            return {"message": "Training"}, 200

    def _model_path(model_name: str) -> Optional[str]:
        for item in state.list_models():
            if (item["model_name"] == model_name
                    and item["inference_model_path"] is not None
                    and item["status"] == "ready"):
                return item["inference_model_path"]
        return None

    @app.route("/segment", methods=["POST"])
    def segment(req: Request):
        """(reference scripts/backend.py:237-309)"""
        with state.sem:
            try:  # what the request asks for; a fault here is the client's
                model_name = req.form_get("model_name") or "whisperseg-base"
                model_name = model_name.lower().strip()
                min_frequency = req.form_get("min_frequency", type=int)
                spec_time_step = req.form_get("spec_time_step", type=float)
                channel_id = req.form_get("channel_id", type=int, default=0)
                num_trials = req.form_get("num_trials", type=int, default=1)
                frame_mode = req.form_get("frame_mode", type=int, default=0)
                if "audio_file" not in req.files:
                    raise ValueError("No audio_file is provided")
                model_path = _model_path(model_name)
                if model_path is None:
                    raise ValueError("model_name is not available for inference")
                audio, sr = load_audio(io.BytesIO(req.files["audio_file"]),
                                       mono=False, channel_id=channel_id)
                if audio.ndim == 2:
                    audio = audio[channel_id]
            except Exception:
                print("Segmentation request refused: returning an empty "
                      "prediction", flush=True)
                traceback.print_exc()
                return dict(_EMPTY), 400
            # whatever the segmenter raises answers 500 (module doc)
            segmenter = state.get_segmenter(model_name, model_path)
            if frame_mode:
                prediction = segmenter.segment_from_frames(
                    audio, sr, min_frequency=min_frequency,
                    spec_time_step=spec_time_step, batch_size=8,
                )
            else:
                prediction = segmenter.segment(
                    audio, sr, min_frequency=min_frequency,
                    spec_time_step=spec_time_step, num_trials=num_trials,
                    batch_size=8,
                )
            if model_name in PROCESS_TOOLBOX:
                prediction = PROCESS_TOOLBOX[model_name](prediction)
            return prediction, 200

    return app


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", "--flask_port", dest="port", default=8060,
                        type=int)
    parser.add_argument("--dataset_base_folder", type=str, required=True)
    parser.add_argument("--model_base_folder", type=str, required=True)
    parser.add_argument("--max_num_segmenters_in_ram", default=1, type=int)
    parser.add_argument("--compute_type", default="bfloat16",
                        choices=["float32", "bfloat16", "int8", "int4"],
                        help="weight precision for served segmenters")
    parser.add_argument("--training_timeout", type=float, default=None,
                        help="kill a training job after this many seconds "
                             "(default: no limit)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu; also passed to the "
                             "training subprocess")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    # the models shipped in the repository, ready for inference and for
    # fine-tuning (the reference's hub models, scripts/backend.py:368-375)
    from ..hub import builtin_models

    pretrained = [{"model_name": name, "inference_model_path": path,
                   "finetune_model_path": path}
                  for name, path in builtin_models().items()]
    state = BackendState(args.dataset_base_folder, args.model_base_folder,
                         args.max_num_segmenters_in_ram,
                         pretrained_models=pretrained,
                         inference_dtype=args.compute_type,
                         training_timeout=args.training_timeout,
                         device=args.device)
    threading.Thread(target=state.run_training_worker, daemon=True).start()
    threading.Thread(target=state.periodic_list_models, daemon=True).start()
    app = build_app(state)
    print("Waiting for requests...", flush=True)
    app.serve("0.0.0.0", args.port)


if __name__ == "__main__":
    main()
