"""The plain reference agrees with the port at a tiny size on the CPU, in
float32: features, encoder states, teacher-forced logits, frame head,
training targets and one AdamW step. (These tests import the port; the
reference itself does not.)"""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import traffic, weights as wt
from perfbench.common import ROOT, program_config
from perfbench.reference import frontend as rf
from perfbench.reference import model as rm
from perfbench.reference import targets as rt

TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
MODEL = {"name": "tiny", "d_model": 128, "encoder_layers": 2,
         "decoder_layers": 2, "encoder_attention_heads": 2,
         "decoder_attention_heads": 2, "encoder_ffn_dim": 256,
         "decoder_ffn_dim": 256, "num_mel_bins": 80,
         "max_source_positions": 500, "max_target_positions": 448,
         "vocab_size": 1024, "total_spec_columns": 1000,
         "compute_dtype": "float32", "frame_head_clusters": None}


@pytest.fixture(scope="module")
def clips():
    audio = traffic.tone_bursts(11, duration=5.0)
    return rf.sliding_windows(audio, 32000, 0.0025, 1000, 2)


def test_features_match_the_port(clips):
    from whisperseg_torch.audio.frontend import Frontend

    fe = Frontend(32000, 0.0025, 0)
    got = fe.features_for_clips(torch.from_numpy(clips), 1000, device="cpu")
    want = np.stack([rf.window_features(c, 32000, 0.0025, 0, 1000)
                     for c in clips])
    assert np.abs(got.numpy() - want).max() < 1e-4


def test_windows_match_the_port(clips):
    from whisperseg_torch.segmenter import Segmenter

    seg = Segmenter.__new__(Segmenter)
    seg.total_spec_columns = 1000
    got, _ = seg.slice_audio_windows(traffic.tone_bursts(11, duration=5.0),
                                     32000, 0.0025, 2)
    assert np.array_equal(got, clips)


@torch.no_grad()
def test_encoder_decoder_and_frame_head_match_the_port(clips):
    from whisperseg_torch.models import whisper

    flat = wt.checkpoint_weights(TINY)
    with open(os.path.join(TINY, "config.json")) as f:
        meta = json.load(f)
    model = dict(MODEL, d_model=384, encoder_layers=4, decoder_layers=4,
                 encoder_attention_heads=6, decoder_attention_heads=6,
                 encoder_ffn_dim=1536, decoder_ffn_dim=1536,
                 frame_head_clusters=meta["frame_head_clusters"])
    cfg = program_config(model)
    feats = torch.from_numpy(np.stack([
        rf.window_features(c, 32000, 0.0025, 0, 1000) for c in clips[:2]]))
    enc = whisper.encoder_forward(wt.tree(flat), cfg, feats)
    ref = rm.encoder(flat, feats, 4, 6)
    assert (enc - ref).abs().max() < 2e-4 * ref.abs().max()
    ids = torch.tensor([[12, 13, 14, 20, 40, 0, 60, 11]] * 2)
    got = whisper.decoder_forward_train(wt.tree(flat), cfg, enc, ids)
    want = rm.decoder(flat, ref, ids, 4, 6)
    assert (got - want).abs().max() < 2e-4 * want.abs().max()
    fh = whisper.frame_head_forward(wt.tree(flat), cfg, enc)
    assert (fh - rm.frame_head(flat, ref)).abs().max() < 1e-3


def test_random_weights_cover_the_ports_tree():
    from whisperseg_torch.models.whisper import init_params

    flat = wt.random_weights(MODEL, 2 ** 40 + 3, "cpu", torch.float32)
    cfg = program_config(MODEL)
    want = wt.flat(init_params(torch.Generator().manual_seed(0), cfg))
    assert set(flat) == set(want)
    assert all(flat[k].shape == want[k].shape for k in want)
    again = wt.random_weights(MODEL, 2 ** 40 + 3, "cpu", torch.float32)
    assert all(torch.equal(flat[k], again[k]) for k in flat)


def test_training_targets_match_the_ports_data_path(tmp_path):
    from whisperseg_torch import data as wd

    mix = {"files": 2, "file_s": 6.0, "sr": 32000, "spec_time_step": 0.0025,
           "min_frequency": 0}
    traffic.write_labelled_files(str(tmp_path), mix, 5)
    paths, labels = wd.get_audio_and_label_paths(str(tmp_path))
    default = wd.resolve_default_config(paths, labels, 1000)
    audio, lab = wd.load_data(paths, labels, {"Vocal": 0},
                              default_config=default)
    audio, lab = wd.slice_audios_and_labels(audio, lab, 1000)
    ds = wd.VocalSegDataset(audio, lab, 100, 1000, device="cpu")
    import wave
    k = 0
    for path in paths:
        with wave.open(path) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        label = json.load(open(path[:-4] + ".json"))
        for piece, on, off in rt.windows(rf.pcm16_to_float(pcm),
                                         label["onset"], label["offset"],
                                         32000, 0.0025, 1000):
            item = ds.__getitem__(k, rng=np.random.RandomState(k))
            s = rt.find_crop(piece, item["audio_clip"])
            assert s >= 0
            inp, lab_ids = rt.crop_target(on, off, s, min(80000, len(piece) - s),
                                          32000, 0.0025, 1000, 100)
            assert np.array_equal(inp, item["decoder_input_ids"])
            assert np.array_equal(lab_ids, item["labels"])
            k += 1
    assert k == len(ds)


def test_adamw_step_matches_torch():
    torch.manual_seed(0)
    w = {"a_w": torch.randn(5, 3), "a_b": torch.randn(3)}
    g = {k: torch.randn_like(v) for k, v in w.items()}
    ref = {k: v.clone() for k, v in w.items()}
    opt = rm.AdamW(ref, rm.decay_leaves(ref))
    p = [w["a_w"].clone().requires_grad_(), w["a_b"].clone().requires_grad_()]
    torch_opt = torch.optim.AdamW([{"params": [p[0]], "weight_decay": 0.01},
                                   {"params": [p[1]], "weight_decay": 0.0}],
                                  lr=1e-3)
    for _ in range(3):
        opt.step(g, 1e-3)
        p[0].grad, p[1].grad = g["a_w"].clone(), g["a_b"].clone()
        torch_opt.step()
    assert torch.allclose(ref["a_w"], p[0].detach(), atol=1e-6)
    assert torch.allclose(ref["a_b"], p[1].detach(), atol=1e-6)


@pytest.mark.parametrize("knobs", [
    dict(vocal_threshold=0.6, cut_threshold=0.3, boundary_snap=2, gap_cut=0),
    dict(vocal_threshold=0.5, cut_threshold=0.5, boundary_snap=4, gap_cut=5),
    dict(vocal_threshold=0.3, cut_threshold=0.7, boundary_snap=8, gap_cut=2)])
def test_the_frame_tail_matches_the_port(knobs):
    """The reference host tail returns the port's table, to the last digit,
    on tracks with runs, event peaks, cuts and several clusters."""
    from whisperseg_torch.refine import segments_from_tracks
    from whisperseg_torch.segmenter import _tracks_from_window_frames
    from perfbench.reference import tail

    rng = np.random.RandomState(5)
    names = {0: "Vocal", 1: "b", 2: "c"}
    for trial in range(20):
        n, s = 3, 500
        smooth = np.cumsum(rng.randn(n * s, 3), axis=0)
        smooth -= np.convolve(smooth[:, 0], np.ones(41) / 41, "same")[:, None]
        probs = (1 / (1 + np.exp(-smooth / 3))).astype(np.float32)
        probs = probs.reshape(n, s, 3)
        cluster = rng.randint(-1, 3, size=(n, s)).astype(np.int32)
        duration = (n * s - rng.randint(0, 400)) * 0.005
        got = segments_from_tracks(
            _tracks_from_window_frames(probs, cluster, duration, 0.0025),
            duration, 256 / 32000, names, min_segment_length=0.005,
            precision_bits=3, **knobs)
        want = tail.table(tail.tracks(probs, cluster, duration, 0.0025),
                          duration, 32000, names, min_segment_length=0.005,
                          precision_bits=3, **knobs)
        assert want["onset"], trial
        assert got == want, trial
