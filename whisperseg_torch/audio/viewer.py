"""Spectrogram + annotation visualization (the port of
``whisperseg_tpu/audio/viewer.py``, itself a port of the reference's
SpecViewer, audio_utils.py:78-242).

Renders a magma-colormap spectrogram stacked with prediction/label color bars
(one color per cluster) and time-axis ticks. Works in three modes:

  * ``visualize(...)`` inside a notebook with ipywidgets -> interactive slider
    over time offsets, like the reference;
  * ``visualize(..., offset=t)`` anywhere -> a single matplotlib figure;
  * ``save(...)`` -> PNG on disk (headless servers / CI).

The spectrogram is the port's batched log-mel frontend
(``Frontend.log_mel_batch``) on the viewer's device: the card, through the
mel kernel, unless ``SpecViewer(device="cpu")`` asks for the CPU. Drawing
needs matplotlib.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import torch

from ..runtime import resolve_device
from .frontend import Frontend


class SpecViewer:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        import matplotlib.cm as cm
        import matplotlib.colors as mcolors

        colors = [
            np.array(mcolors.hex2color(c))
            for c in (list(mcolors.TABLEAU_COLORS.values())
                      + list(mcolors.CSS4_COLORS.values()))
        ][1:]  # skip the first color, as the reference does
        unique = []
        for c in colors:
            if not any(np.all(u == c) for u in unique):
                unique.append(c)
        unique = np.asarray(unique)
        # drop too-light colors (invisible on white)
        self.colors = unique[unique.mean(axis=1) < 0.8]
        # cm.get_cmap is removed in matplotlib 3.11
        import matplotlib

        self.cmap = matplotlib.colormaps["magma"]

    # ------------------------------------------------------------------ helpers

    @staticmethod
    def chunk_audio(audio, start_time, end_time, sr):
        return audio[int(start_time * sr):int(end_time * sr)]

    @staticmethod
    def chunk_label(label: Dict, start_time: float, end_time: float) -> Dict:
        onset = np.asarray(label["onset"], dtype=float)
        offset = np.asarray(label["offset"], dtype=float)
        inter = np.logical_and(onset < end_time, offset > start_time)
        return {
            "onset": (np.maximum(onset[inter], start_time) - start_time).tolist(),
            "offset": (np.minimum(offset[inter], end_time) - start_time).tolist(),
            "cluster": [label["cluster"][i] for i in np.nonzero(inter)[0]],
        }

    def spectrogram(self, frontend: Frontend, audio) -> np.ndarray:
        """(80, columns) log-mel features of ``audio`` on the viewer's
        device, as a numpy array."""
        clip = torch.as_tensor(np.asarray(audio, np.float32)[None],
                               device=self.device)
        return frontend.log_mel_batch(clip)[0].cpu().numpy()

    @staticmethod
    def min_max_norm(im, min_value=None, max_value=None):
        min_value = im.min() if min_value is None else min_value
        max_value = im.max() if max_value is None else max_value
        return (im - min_value) / max(max_value - min_value, 1e-12)

    def _bar_image(self, chunked, spec_cols, spec_time_step, color_mapper):
        bar = np.ones((spec_cols, 3), dtype=np.float32)
        onsets = chunked["onset"]
        for pos in range(len(onsets)):
            a = int(np.round(chunked["onset"][pos] / spec_time_step))
            b = int(np.round(chunked["offset"][pos] / spec_time_step))
            cluster = chunked["cluster"][pos]
            # visual gap between two abutting same-cluster segments
            if (pos + 1 < len(onsets)
                    and b == int(np.round(chunked["onset"][pos + 1] / spec_time_step))
                    and cluster == chunked["cluster"][pos + 1]):
                b -= 1
            bar[a:b, :] = color_mapper[cluster]
        return np.tile(bar[None, :, :], [40, 1, 1])

    # ------------------------------------------------------------------- render

    @staticmethod
    def _track_strip(track, quantum, start_time, spec_cols, spec_time_step,
                     rgb, height=14):
        """Rasterize one frame-head probability track onto the spectrogram
        column grid as a color-intensity strip (white = 0, full color = 1)."""
        strip = np.ones((height, spec_cols, 3))
        t = start_time + np.arange(spec_cols) * spec_time_step
        idx = np.round(t / quantum).astype(int)
        valid = (idx >= 0) & (idx < len(track))
        p = np.zeros(spec_cols)
        p[valid] = np.clip(np.asarray(track)[idx[valid]], 0.0, 1.0)
        for c in range(3):
            strip[:, :, c] = 1.0 - p[None, :] * (1.0 - rgb[c])
        return strip

    def render(self, offset, window_size, audio, prediction, label, sr,
               audio_file_name, frontend: Frontend, precision_bits=3,
               min_spec_value=None, max_spec_value=None, xticks_step_size=0.5,
               tracks=None):
        import matplotlib.pyplot as plt
        from matplotlib.patches import Patch

        clusters = sorted(set(list(label["cluster"]) + list(prediction["cluster"])))
        color_mapper = {c: self.colors[i % len(self.colors)]
                        for i, c in enumerate(clusters)}
        patches = [Patch(color=color, label=c) for c, color in color_mapper.items()]

        start_time, end_time = offset, offset + window_size
        audio_chunk = self.chunk_audio(audio, start_time, end_time, sr)
        label_chunk = self.chunk_label(label, start_time, end_time)
        pred_chunk = self.chunk_label(prediction, start_time, end_time)

        spec = self.spectrogram(frontend, audio_chunk)
        spec_colorful = np.flip(
            self.cmap(self.min_max_norm(spec, min_spec_value, max_spec_value))[:, :, :3],
            axis=0,
        )

        spec_time_step = frontend.hop_length / sr
        tick_step = int(np.round(xticks_step_size / spec_time_step))
        tick_values = np.arange(0, spec.shape[1] + 1, max(tick_step, 1))
        fmt = f"%.{precision_bits}f"
        tick_labels = [fmt % (v * spec_time_step + start_time) for v in tick_values]

        preds_img = self._bar_image(pred_chunk, spec.shape[1], spec_time_step,
                                    color_mapper)
        labels_img = self._bar_image(label_chunk, spec.shape[1], spec_time_step,
                                     color_mapper)

        h = spec_colorful.shape[0]
        extra = 64 if tracks is not None else 0
        canvas = np.ones((h + 100 + extra, spec.shape[1], 3))
        canvas[:h] = spec_colorful
        canvas[h + 10:h + 50] = preds_img
        canvas[h + 60:h + 100] = labels_img
        if tracks is not None:
            # frame-head probability strips: vocal (green), onset (blue),
            # offset (red) — Segmenter.frame_probs output
            q = float(tracks["quantum"])
            for i, (name, rgb) in enumerate(
                    (("vocal", (0.05, 0.55, 0.15)),
                     ("onset", (0.1, 0.2, 0.8)),
                     ("offset", (0.75, 0.1, 0.1)))):
                y = h + 106 + i * 18
                canvas[y:y + 14] = self._track_strip(
                    tracks[name], q, start_time, spec.shape[1], spec_time_step,
                    rgb)

        fig, ax = plt.subplots(nrows=1, ncols=1, figsize=(10, 4),
                               tight_layout=True)
        ax.imshow(canvas, interpolation="bilinear")
        ax.spines[["top", "right", "left"]].set_visible(False)
        ax.text(-137, 35, "Spectrogram:", fontfamily="monospace")
        ax.text(-137, -20, f"Wav file name: {audio_file_name}",
                fontfamily="monospace")
        ax.text(-137, h + 35, "Prediction:", fontfamily="monospace")
        ax.text(-137, h + 85, "Label:", fontfamily="monospace")
        if tracks is not None:
            ax.text(-137, h + 150, "Frame head:\n(voc/on/off)",
                    fontfamily="monospace")
        ax.set_yticks([])
        ax.set_xticks(tick_values, tick_labels)
        ax.set_xlabel("time (s)")
        if patches:
            ax.legend(handles=patches, loc="upper center",
                      bbox_to_anchor=(0.5, -0.5), ncol=4)
        return fig

    # ---------------------------------------------------------------- frontends

    @staticmethod
    def _normalize_tables(prediction, label):
        def to_dict(x):
            if x is None:
                return {"onset": [], "offset": [], "cluster": []}
            if hasattr(x, "to_dict") and not isinstance(x, dict):  # DataFrame
                x = x.to_dict("list")
            x = dict(x)
            if "cluster" not in x:  # optional, like data.read_label
                x["cluster"] = ["Vocal"] * len(x.get("onset", []))
            x["cluster"] = list(map(str, x["cluster"]))
            return x

        return to_dict(prediction), to_dict(label)

    def visualize(self, audio, sr, prediction=None, label=None,
                  min_frequency=None, max_frequency=None, precision_bits=3,
                  audio_file_name="", window_size=5.0, xticks_step_size=0.5,
                  spec_width=1000, offset: Optional[float] = None,
                  tracks=None):
        """Interactive (ipywidgets slider) when available and ``offset`` is None;
        otherwise renders a single figure at the given offset. Pass ``tracks``
        (from ``Segmenter.frame_probs``) to overlay the frame-head
        vocal/onset/offset probability strips."""
        prediction, label = self._normalize_tables(prediction, label)
        frontend = Frontend(sr, window_size / spec_width,
                            min_frequency or 0, max_frequency)

        def plot(offset):
            import matplotlib.pyplot as plt

            self.render(offset, window_size, audio, prediction, label, sr,
                        audio_file_name, frontend, precision_bits,
                        xticks_step_size=xticks_step_size, tracks=tracks)
            plt.show()

        if offset is not None:
            return plot(offset)
        try:
            from ipywidgets import fixed, interact  # noqa: F401

            return interact(
                plot,
                offset=(0, max(0, len(audio) / sr - window_size), window_size / 20),
            )
        except ImportError:
            return plot(0.0)

    def save(self, path, audio, sr, prediction=None, label=None, offset=0.0,
             window_size=5.0, spec_width=1000, min_frequency=None,
             max_frequency=None, audio_file_name="", tracks=None):
        """Render one window to a PNG (headless mode)."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        prediction, label = self._normalize_tables(prediction, label)
        frontend = Frontend(sr, window_size / spec_width,
                            min_frequency or 0, max_frequency)
        fig = self.render(offset, window_size, audio, prediction, label, sr,
                          audio_file_name, frontend, tracks=tracks)
        fig.savefig(path, dpi=100)
        import matplotlib.pyplot as plt

        plt.close(fig)
        return path


def slice_audio_and_label(audio, label, sr, start_time, end_time):
    """Clip audio + label table to [start_time, end_time]
    (reference audio_utils.py:245-270)."""
    sliced = audio[int(start_time * sr):int(end_time * sr)]
    end_time = start_time + len(sliced) / sr
    onsets = np.asarray(label["onset"], dtype=float)
    offsets = np.asarray(label["offset"], dtype=float)
    idx = np.nonzero(np.logical_and(onsets < end_time, offsets > start_time))[0]
    out = {
        "onset": [max(0, onsets[i] - start_time) for i in idx],
        "offset": [min(offsets[i] - start_time, end_time - start_time) for i in idx],
        "cluster": [label["cluster"][i] for i in idx],
    }
    if hasattr(label, "to_dict") and not isinstance(label, dict):
        out = type(label)(out)  # a DataFrame in, a DataFrame out
    return sliced, out
