r"""Segmentation CLI (the port of ``whisperseg_tpu/cli/segment.py``; the same
flags and the same CSV bytes).

    python -m whisperseg_torch.cli.segment \
        --model_path pretrained/whisperseg-base-animal-vad \
        --audio_path rec.wav --csv_save_path out.csv

Takes one ``--audio_path`` (``-`` = audio bytes on stdin) or an
``--audio_folder`` (its wav/flac/mp3/ogg files, prepending a ``filename``
column) and writes the CSV to a path or, with ``--csv_save_path buffer``, to
stdout. It runs on the card;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import io
import os
import sys


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--audio_path", default=None,
                        help="Path to a .wav file, or '-' for wav bytes on stdin")
    parser.add_argument("--audio_folder", default=None,
                        help="Folder of .wav files (used when audio_path is None)")
    parser.add_argument("--csv_save_path", required=True,
                        help="Output .csv path, or 'buffer' for stdout")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--device_ids", type=int, nargs="+", default=[0],
                        help="accepted for compatibility; one card is used")
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--min_frequency", default=None, type=int)
    parser.add_argument("--spec_time_step", default=None, type=float)
    parser.add_argument("--num_trials", default=1, type=int)
    parser.add_argument("--num_beams", default=4, type=int)
    parser.add_argument("--draft_model_path", default=None,
                        help="draft checkpoint for greedy speculative decoding "
                             "(Segmenter.set_draft_model)")
    parser.add_argument("--spec_k", default=4, type=int,
                        help="Draft tokens per speculative step")
    parser.add_argument("--merge_gap_ms", default=None, type=float,
                        help="opt-in merge of same-cluster predictions whose "
                             "gap is below this (spurious splits; refine.py)")
    parser.add_argument("--split_merged_db", default=None, type=float,
                        help="opt-in energy-valley split of merged segments "
                             "(dB drop below both flanks; see refine.py)")
    parser.add_argument("--refine_boundaries_ms", default=None, type=float,
                        help="opt-in energy-edge boundary refinement: search "
                             "half-width in ms (see refine.py)")
    parser.add_argument("--frame_split", default=None, type=float,
                        help="opt-in frame-head split of decoder merges: "
                             "event-track cut threshold 0..1 (needs a model "
                             "trained with --frame_head; refine.py)")
    parser.add_argument("--frame_refine_ms", default=None, type=float,
                        help="opt-in frame-head boundary snap: search "
                             "half-width in ms (needs --frame_head model)")
    parser.add_argument("--frame_filter", default=None, type=float,
                        help="opt-in frame-head hallucination filter: drop "
                             "segments whose mean vocal probability is below "
                             "this (0..1; needs --frame_head model)")
    parser.add_argument("--frame_mode", default=0, type=int,
                        help="1: decoder-free frame-VAD segmentation "
                             "(Segmenter.segment_from_frames; needs a "
                             "--frame_head model)")
    parser.add_argument("--frame_vocal_threshold", default=None, type=float,
                        help="frame mode: vocal-probability threshold "
                             "(default: checkpoint's fitted value, else 0.5)")
    parser.add_argument("--frame_cut_threshold", default=None, type=float,
                        help="frame mode: event-track cut threshold "
                             "(default: checkpoint's fitted value, else 0.5)")
    parser.add_argument("--frame_boundary_snap", default=None, type=int,
                        help="frame mode: boundary snap radius in grid "
                             "positions (default: fitted value, else 2)")
    parser.add_argument("--frame_gap_cut", default=None, type=int,
                        help="frame mode: split active runs at offset->onset "
                             "event pairs up to this many grid positions "
                             "apart (sub-floor pause cut; default: fitted "
                             "value, else 0 = same-position cuts only)")
    parser.add_argument("--max_length", default=None, type=int,
                        help="decode token budget; default = the budget the "
                             "checkpoint was trained at (its "
                             "default_segmentation_config), else 448")
    parser.add_argument("--streaming", default=0, type=int,
                        help="1: bounded-memory streaming segmentation for "
                             "long WAV recordings (Segmenter."
                             "segment_streaming): the file is read in "
                             "--chunk_seconds chunks instead of whole, "
                             "resampled to the model's sampling rate (else "
                             "the file's own). Needs a file path (not "
                             "stdin). Works with --frame_mode.")
    parser.add_argument("--chunk_seconds", default=60.0, type=float,
                        help="streaming mode: seconds of audio per chunk "
                             "(peak memory is O(chunk))")
    parser.add_argument("--compute_type", default="bfloat16",
                        choices=["float32", "bfloat16", "int8", "int4"],
                        help="inference weight precision (int8 = per-channel "
                             "int8 weights; int4 = w4a16)")
    return parser


def write_csv(out, table: dict) -> None:
    """``table`` ({column: values}, one order of columns) as CSV, byte for
    byte what ``pandas.DataFrame(table).to_csv(out, index=False)`` writes:
    a header, then one row a segment, floats in their shortest repr, "\\n"
    line ends, fields quoted only where needed."""
    writer = csv.writer(out, lineterminator="\n")
    writer.writerow(list(table))
    writer.writerows(zip(*table.values()))


def main(argv=None):
    from ..audio.io import load_audio
    from ..segmenter import Segmenter

    parser = build_parser()
    args = parser.parse_args(argv)
    if not (args.csv_save_path.endswith(".csv")
            or args.csv_save_path == "buffer"):
        parser.error("csv_save_path must end with .csv or be 'buffer'")

    segmenter = Segmenter.from_pretrained(
        args.model_path, inference_dtype=args.compute_type, device=args.device)
    if args.draft_model_path:
        segmenter.set_draft_model(args.draft_model_path, spec_k=args.spec_k)

    def run_streaming(path):
        return segmenter.segment_streaming(
            path, chunk_seconds=args.chunk_seconds,
            frame_mode=bool(args.frame_mode),
            min_frequency=args.min_frequency,
            spec_time_step=args.spec_time_step,
            batch_size=args.batch_size,
            num_trials=args.num_trials, num_beams=args.num_beams,
            max_length=args.max_length, merge_gap_ms=args.merge_gap_ms,
            frame_split=args.frame_split,
            frame_refine_ms=args.frame_refine_ms,
            frame_filter=args.frame_filter,
            vocal_threshold=args.frame_vocal_threshold,
            cut_threshold=args.frame_cut_threshold,
            boundary_snap=args.frame_boundary_snap,
            gap_cut=args.frame_gap_cut,
        )

    def run(audio, sr):
        if args.frame_mode:
            ignored = [name for name, val, default in (
                ("--num_trials", args.num_trials, 1),
                ("--num_beams", args.num_beams, 4),
                ("--refine_boundaries_ms", args.refine_boundaries_ms, None),
                ("--split_merged_db", args.split_merged_db, None),
                ("--merge_gap_ms", args.merge_gap_ms, None),
                ("--frame_split", args.frame_split, None),
                ("--frame_refine_ms", args.frame_refine_ms, None),
                ("--frame_filter", args.frame_filter, None),
            ) if val != default]
            if ignored:
                print(f"Note: frame mode (decoder-free) ignores "
                      f"{', '.join(ignored)}; its own knobs are "
                      f"--frame_vocal_threshold/--frame_cut_threshold/"
                      f"--frame_boundary_snap/--frame_gap_cut.",
                      file=sys.stderr)
            return segmenter.segment_from_frames(
                audio, sr, min_frequency=args.min_frequency,
                spec_time_step=args.spec_time_step,
                batch_size=args.batch_size,
                vocal_threshold=args.frame_vocal_threshold,
                cut_threshold=args.frame_cut_threshold,
                boundary_snap=args.frame_boundary_snap,
                gap_cut=args.frame_gap_cut,
            )
        return segmenter.segment(
            audio, sr, min_frequency=args.min_frequency,
            spec_time_step=args.spec_time_step, num_trials=args.num_trials,
            batch_size=args.batch_size, num_beams=args.num_beams,
            max_length=args.max_length,
            refine_boundaries_ms=args.refine_boundaries_ms,
            split_merged_db=args.split_merged_db,
            merge_gap_ms=args.merge_gap_ms,
            frame_split=args.frame_split,
            frame_refine_ms=args.frame_refine_ms,
            frame_filter=args.frame_filter,
        )

    if args.audio_path is None:
        if args.audio_folder is None:
            parser.error(
                "Either audio_path or audio_folder needs to be specified!")
        # case-insensitive extension match: field recorders often write
        # upper-case names
        exts = (".wav", ".flac", ".mp3", ".ogg")
        paths = sorted(
            os.path.join(args.audio_folder, f)
            for f in os.listdir(args.audio_folder)
            if os.path.splitext(f)[1].lower() in exts)
        table = {"filename": [], "onset": [], "offset": [], "cluster": []}
        for i, path in enumerate(paths, 1):
            if args.streaming:
                res = run_streaming(path)
            else:
                audio, sr = load_audio(path)
                res = run(audio, sr)
            table["filename"] += [os.path.basename(path)] * len(res["onset"])
            table["onset"] += res["onset"]
            table["offset"] += res["offset"]
            table["cluster"] += res["cluster"]
            print(f"segment: {i}/{len(paths)} files", file=sys.stderr,
                  flush=True)
    elif args.audio_path == "-":
        if args.streaming:
            parser.error("--streaming needs a file path, not stdin")
        table = run(*load_audio(sys.stdin.buffer.read()))
    elif args.streaming:
        table = run_streaming(args.audio_path)
    else:
        table = run(*load_audio(args.audio_path))

    if args.csv_save_path == "buffer":
        buf = io.StringIO()
        write_csv(buf, table)
        print(buf.getvalue())
    else:
        with open(args.csv_save_path, "w", newline="") as f:
            write_csv(f, table)


if __name__ == "__main__":
    main()
