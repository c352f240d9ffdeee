r"""Single-model segmentation service (the port of
``whisperseg_tpu/services/segment_service.py``).

    python -m whisperseg_torch.services.segment_service \
        --model_path pretrained/whisperseg-base-animal-vad --continuous_batching 1

``POST /segment`` with a JSON body ``{audio_file_base64_string, sr,
min_frequency?, spec_time_step?, min_segment_length?, eps?, num_trials?
(default 3), channel_id?, adobe_audition_compatible?, frame_mode?,
num_beams?, max_length?, top_p?, and the post-processing knobs}`` -> 201 with
``{onset, offset, cluster}`` in that key order. A body that cannot be read,
or an option of the wrong type or out of its range (checked before the
segmenter runs), gets an empty prediction; whatever the segmenter raises is
not caught and answers 500. Without
``--continuous_batching`` a semaphore serializes requests on the model; with
it, a ``BatchingSegmenter`` fuses the windows of concurrent requests. The
Adobe Audition mode reshapes the output into a cue-sheet table with a BOM'd
Name column and decimal H:MM:SS.mmm times. ``GET /status`` answers when the
service is up.

The service runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import base64
import io
import math
import threading
import traceback

from .http_util import JsonHTTPServer, Request


def decimal_to_seconds(decimal_time: str) -> float:
    splits = decimal_time.split(":")
    if len(splits) == 2:
        hours, (minutes, seconds) = 0, splits
    elif len(splits) == 3:
        hours, minutes, seconds = splits
    else:
        raise ValueError(decimal_time)
    return int(hours) * 3600 + int(minutes) * 60 + float(seconds)


def seconds_to_decimal(seconds: float) -> str:
    """H:MM:SS.mmm (M:SS.mmm under an hour); minutes are taken modulo the
    hour, so 3661 s is 1:01:01.000."""
    hours = int(seconds // 3600)
    minutes = int(seconds % 3600 // 60)
    seconds = seconds % 60
    if hours > 0:
        return "%d:%02d:%06.3f" % (hours, minutes, seconds)
    return "%d:%06.3f" % (minutes, seconds)


def adobe_audition_format(prediction: dict) -> dict:
    starts = [seconds_to_decimal(s) for s in prediction["onset"]]
    durations = [
        seconds_to_decimal(e - s)
        for s, e in zip(prediction["onset"], prediction["offset"])
    ]
    n = len(starts)
    return {
        "﻿Name": [""] * n,
        "Start": starts,
        "Duration": durations,
        "Time Format": ["decimal"] * n,
        "Type": ["Cue"] * n,
        "Description": [""] * n,
    }


# request options and the values each admits (None leaves the default)
_POSITIVE_INTS = ("num_trials", "num_beams", "max_length")
_POSITIVE = ("spec_time_step", "eps")
_NON_NEGATIVE = ("min_frequency", "min_segment_length", "refine_boundaries_ms",
                 "split_merged_db", "merge_gap_ms", "frame_split",
                 "frame_refine_ms", "frame_filter")


def check_options(info: dict, max_length: int) -> None:
    """Raise ValueError for a request option of the wrong type or out of
    its range; ``max_length`` is the decoder's position count."""
    def number(name, v):
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or not math.isfinite(v):
            raise ValueError(f"{name} must be a number, got {v!r}")
        return v
    for name in _POSITIVE_INTS:
        v = info.get(name)
        if v is not None and (isinstance(v, bool) or not isinstance(v, int)
                              or v < 1):
            raise ValueError(f"{name} must be a positive integer, got {v!r}")
    if info.get("max_length", 1) > max_length:
        raise ValueError(f"max_length must be at most {max_length}")
    for name in _POSITIVE:
        if info.get(name) is not None and number(name, info[name]) <= 0:
            raise ValueError(f"{name} must be positive, got {info[name]!r}")
    for name in _NON_NEGATIVE:
        if info.get(name) is not None and number(name, info[name]) < 0:
            raise ValueError(f"{name} must be >= 0, got {info[name]!r}")
    top_p = info.get("top_p")
    if top_p is not None and not 0 < number("top_p", top_p) <= 1:
        raise ValueError(f"top_p must be in (0, 1], got {top_p!r}")


def _empty(reason: str) -> dict:
    print(f"Segmentation Error! Returning an empty prediction ... ({reason})",
          flush=True)
    traceback.print_exc()
    return {"onset": [], "offset": [], "cluster": []}


def build_app(segmenter, batch_size: int = 8,
              serialize: bool = True) -> JsonHTTPServer:
    """``serialize=False`` admits concurrent requests (for a
    BatchingSegmenter, which fuses their windows into shared device
    batches)."""
    from ..audio.io import load_audio

    app = JsonHTTPServer()
    sem = threading.Semaphore(1 if serialize else 1024)

    def segment_request(info: dict, audio, sr):
        if info.get("frame_mode", False):
            return segmenter.segment_from_frames(
                audio, sr=sr,
                min_frequency=info.get("min_frequency", None),
                spec_time_step=info.get("spec_time_step", None),
                batch_size=batch_size,
            )
        return segmenter.segment(
            audio, sr=sr,
            min_frequency=info.get("min_frequency", None),
            spec_time_step=info.get("spec_time_step", None),
            min_segment_length=info.get("min_segment_length", None),
            eps=info.get("eps", None),
            num_trials=info.get("num_trials", 3),
            batch_size=batch_size,
            num_beams=info.get("num_beams", 4),
            max_length=info.get("max_length", None),
            top_p=info.get("top_p", 1.0),
            refine_boundaries_ms=info.get("refine_boundaries_ms", None),
            split_merged_db=info.get("split_merged_db", None),
            merge_gap_ms=info.get("merge_gap_ms", None),
            frame_split=info.get("frame_split", None),
            frame_refine_ms=info.get("frame_refine_ms", None),
            frame_filter=info.get("frame_filter", None),
        )

    @app.route("/segment", methods=["POST"])
    def segment(req: Request):
        with sem:
            stats = None
            try:
                info = {k: v for k, v in req.json.items() if v is not None}
                sr = info["sr"]
                adobe = info.get("adobe_audition_compatible", False)
                audio, _ = load_audio(
                    io.BytesIO(base64.b64decode(info["audio_file_base64_string"])),
                    sr=sr, mono=False, channel_id=info.get("channel_id", 0))
                if audio.ndim == 2:
                    audio = audio[info.get("channel_id", 0)]
                check_options(info, segmenter.config.max_target_positions)
            except Exception:  # a body that cannot be read or bad options
                prediction, adobe = _empty("unreadable body or bad option"), False
            else:
                prediction = segment_request(info, audio, sr)
                if not info.get("frame_mode", False):
                    stats = segmenter.last_consolidation_stats
            if adobe:
                prediction = adobe_audition_format(prediction)
            # additive response metadata: clients learn when the num_trials=3
            # default collapses recall through cross-trial disagreement
            if stats and stats.get("low_agreement"):
                prediction = dict(prediction)
                prediction["warnings"] = [
                    f"low cross-trial agreement: consolidation discarded "
                    f"{stats['n_noise']}/{stats['n_input']} segments "
                    f"({stats['noise_fraction']:.0%}); consider "
                    f"num_trials=1"]
            return prediction, 201

    @app.route("/status", methods=["GET"])
    def status(req: Request):
        return {"status": "ready"}, 200

    return app


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port", "--flask_port", dest="port", default=8050,
                        type=int)
    parser.add_argument("--model_path", default=None,
                        help="checkpoint path or built-in model name; "
                             "default = the shipped multi-species generalist")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--device_ids", type=int, nargs="+", default=[0],
                        help="accepted for compatibility; one card is used")
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--continuous_batching", type=int, default=0,
                        help="admit concurrent requests and fuse their "
                             "windows into shared device batches")
    parser.add_argument("--draft_model_path", default=None,
                        help="draft checkpoint for greedy speculative decoding "
                             "(Segmenter.set_draft_model)")
    parser.add_argument("--spec_k", default=4, type=int)
    parser.add_argument("--warmup", type=int, default=1,
                        help="build the kernels and run one batch of each "
                             "path at start-up (first-request latency)")
    parser.add_argument("--compute_type", default="bfloat16",
                        choices=["float32", "bfloat16", "int8", "int4"],
                        help="serving weight precision (int8 = per-channel "
                             "int8 weights; int4 = w4a16)")
    return parser


def main(argv=None):
    from ..segmenter import Segmenter

    args = build_parser().parse_args(argv)
    if args.model_path is None:
        from ..hub import default_pretrained_model

        args.model_path = default_pretrained_model()
        if args.model_path is None:
            raise SystemExit("no --model_path given and no built-in model "
                             "under pretrained/ — train one or pass a path")
        print(f"using the shipped default model: {args.model_path}")

    if args.continuous_batching:
        from .batching import BatchingSegmenter

        segmenter = BatchingSegmenter.from_pretrained(
            args.model_path, inference_dtype=args.compute_type,
            device=args.device)
        segmenter.max_batch_size = args.batch_size
        app = build_app(segmenter, args.batch_size, serialize=False)
    else:
        segmenter = Segmenter.from_pretrained(
            args.model_path, inference_dtype=args.compute_type,
            device=args.device)
        app = build_app(segmenter, args.batch_size)
    if args.draft_model_path:
        segmenter.set_draft_model(args.draft_model_path, spec_k=args.spec_k)
    if args.warmup:
        print("Warming up (building the kernels, one batch of each path) ...",
              flush=True)
        segmenter.warmup(segmenter.default_segmentation_config.get("sr", 32000),
                         batch_size=args.batch_size)
    print("Waiting for requests...", flush=True)
    app.serve("0.0.0.0", args.port)


if __name__ == "__main__":
    main()
