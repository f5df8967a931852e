"""Observability: scalars, alignment heatmaps, audio summaries.

Port of the JAX package's ``utils/metrics.py``. The reference logged loss
scalars, attention-alignment images (the Tacotron health check) and
periodic Griffin-Lim audio through tf.summary. ``SummaryWriter`` writes
them through tensorboardX, with matplotlib drawing the alignments, where
tensorboardX, matplotlib and PIL import. Where one of them is missing it
writes the same three kinds as plain files under the same directory:
scalars as JSON lines (``scalars.jsonl``), alignments as ``.npy`` and audio
as ``.wav``, extending the JAX package's own fallback for audio without
soundfile to the writer as a whole. It names the writer it chose in one
line on standard error.
"""

from __future__ import annotations

import io
import json
import os
import struct
import sys
import zlib

import numpy as np

from tacotron_tpu_torch.data.ljspeech import save_wav


def plot_alignment(alignment: np.ndarray, title: str = "") -> np.ndarray:
    """(dec_steps, T_in) -> HWC uint8 heatmap image (matplotlib, Agg)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
    im = ax.imshow(alignment.T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("decoder step")
    ax.set_ylabel("encoder position")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    buf.seek(0)
    import PIL.Image

    return np.asarray(PIL.Image.open(buf).convert("RGB"))


# viridis at five points, interpolated linearly between them
_HEAT = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98],
                  [253, 231, 37]], np.float64)


def alignment_heatmap(alignment: np.ndarray, width: int = 480) -> np.ndarray:
    """(dec_steps, T_in) -> HWC uint8 heatmap without matplotlib: decoder
    steps left to right, encoder positions bottom to top, as
    ``plot_alignment`` draws them, each cell a block of pixels, the colour
    scaled to the map's own range."""
    a = np.asarray(alignment, np.float64)
    lo, hi = a.min(), a.max()
    t = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    x = t * (len(_HEAT) - 1)
    i = np.minimum(x.astype(int), len(_HEAT) - 2)
    rgb = _HEAT[i] + (x - i)[..., None] * (_HEAT[i + 1] - _HEAT[i])
    img = rgb.transpose(1, 0, 2)[::-1]                # (T_in, dec_steps, 3), origin lower
    sx = max(1, width // img.shape[1])
    sy = max(1, (width * 2 // 3) // img.shape[0])
    return np.repeat(np.repeat(img, sy, axis=0), sx, axis=1).round().astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """An HWC uint8 RGB image as a PNG file, with zlib and struct only."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png: RGB images only, got {c} channels")

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = b"".join(b"\x00" + img[y].tobytes() for y in range(h))   # filter 0 a row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows, 9)) + chunk(b"IEND", b""))


def alignment_scores(align: np.ndarray, text_len: int,
                     frame_steps: int) -> dict:
    """Monotonicity metrics of one utterance's attention map.

    ``align``: (dec_steps, T_in). Scored over the active region only.
    Returns monotonic_frac (fraction of adjacent decoder steps whose attention
    argmax does not move backwards, tolerance 1 encoder position), diag_corr
    (Pearson r between argmax position and decoder step: 1.0 is a perfect
    diagonal, the reference's de-facto training health check), and
    span_frac (fraction of encoder positions ever attended)."""
    a = np.asarray(align)[:frame_steps, :text_len]
    pos = a.argmax(axis=-1).astype(np.float64)
    steps = np.arange(len(pos), dtype=np.float64)
    fwd = np.diff(pos) >= -1.0
    corr = float(np.corrcoef(steps, pos)[0, 1]) if pos.std() > 0 else 0.0
    return {
        "monotonic_frac": float(fwd.mean()),
        "diag_corr": corr,
        "span_frac": float(np.unique(pos).size / text_len),
    }


def _file_name(tag: str, step: int, ext: str) -> str:
    return f"{tag.replace('/', '_')}_{step}.{ext}"


class _TensorBoardWriter:
    kind = "tensorboardX"

    def __init__(self, log_dir: str):
        import matplotlib  # noqa: F401  (plot_alignment needs both)
        import PIL  # noqa: F401
        from tensorboardX import SummaryWriter as TBWriter

        self.log_dir = log_dir
        self._w = TBWriter(log_dir)

    def scalar(self, tag, value, step):
        self._w.add_scalar(tag, value, step)

    def alignment(self, tag, alignment, step):
        img = plot_alignment(alignment, title=f"step {step}")
        self._w.add_image(tag, img, step, dataformats="HWC")

    def audio(self, tag, wav, sample_rate, step):
        try:
            self._w.add_audio(tag, np.clip(wav, -1, 1)[None, :], step,
                              sample_rate=sample_rate)
        except ImportError:
            # tensorboardX encodes audio with soundfile; without it the wav
            # goes beside the events
            d = os.path.join(self.log_dir, "audio")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, _file_name(tag, step, "wav"))
            save_wav(path, wav, sample_rate)
            self._w.add_text(tag, f"audio written to {path}", step)

    def flush(self):
        self._w.flush()

    def close(self):
        self._w.close()


class _FileWriter:
    kind = "files"

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._scalars = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def scalar(self, tag, value, step):
        self._scalars.write(json.dumps({"step": step, "tag": tag, "value": value}) + "\n")

    def _path(self, sub, tag, step, ext):
        d = os.path.join(self.log_dir, sub)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, _file_name(tag, step, ext))

    def alignment(self, tag, alignment, step):
        np.save(self._path("alignments", tag, step, "npy"), alignment)

    def audio(self, tag, wav, sample_rate, step):
        save_wav(self._path("audio", tag, step, "wav"), wav, sample_rate)

    def flush(self):
        self._scalars.flush()

    def close(self):
        self._scalars.close()


class _NullWriter:
    kind = "off"

    def scalar(self, tag, value, step):
        pass

    def alignment(self, tag, alignment, step):
        pass

    def audio(self, tag, wav, sample_rate, step):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class SummaryWriter:
    """Scalars, alignments and audio under ``log_dir``; ``kind`` is
    "tensorboardX" or "files", or "off" when not ``enabled`` (the processes
    other than the primary): then nothing is written or created."""

    def __init__(self, log_dir: str, enabled: bool = True):
        if not enabled:
            self._w = _NullWriter()
            self.kind = self._w.kind
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            self._w = _TensorBoardWriter(log_dir)
            why = ""
        except ImportError as e:
            self._w = _FileWriter(log_dir)
            why = f" ({e}): scalars.jsonl, alignments/*.npy, audio/*.wav"
        self.kind = self._w.kind
        print(f"summary writer: {self.kind} in {log_dir}{why}", file=sys.stderr)

    def scalar(self, tag: str, value, step: int):
        self._w.scalar(tag, float(value), step)

    def scalars(self, values: dict, step: int, prefix: str = ""):
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def alignment(self, tag: str, alignment: np.ndarray, step: int):
        self._w.alignment(tag, np.asarray(alignment), step)

    def audio(self, tag: str, wav: np.ndarray, sample_rate: int, step: int):
        self._w.audio(tag, np.asarray(wav), sample_rate, step)

    def flush(self):
        self._w.flush()

    def close(self):
        self._w.close()
