"""Self-contained WAV I/O + resampling + silence trim (numpy/scipy).

The port's copy of `idccrn_vae_tpu/data/audio_io.py`, line for line.
The reference leans on soundfile/librosa (dataset/dataload_*.py,
test_*.py:235-238); neither is a dependency, so the equivalents are
implemented natively:

  * read_wav/write_wav: RIFF PCM16/24/32 + IEEE float via numpy.
  * resample: polyphase (scipy.signal.resample_poly), used where the
    reference calls librosa.resample.
  * trim_silence: librosa.effects.trim semantics (frame RMS in dB
    relative to peak, threshold top_db, frame 2048 / hop 512).

soundfile is used transparently when importable (for flac/ogg etc.).
"""

from __future__ import annotations

import math
import wave
from typing import Tuple

import numpy as np

try:  # optional dependency
    import soundfile as _sf
except Exception:  # pragma: no cover
    _sf = None


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (float32 mono-or-multi (N,) or (N, C), sample_rate)."""
    if _sf is not None:
        data, fs = _sf.read(path, always_2d=False)
        return data.astype(np.float32), int(fs)
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        fs = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # could be PCM32 or float32; wave module reports PCM only.
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
        x = x / float(1 << 23)
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch)
    return x, fs


def write_wav(path: str, x: np.ndarray, fs: int) -> None:
    """Write float32 [-1, 1] as PCM16."""
    if _sf is not None:
        _sf.write(path, x, fs)
        return
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(x, -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(x.shape[1])
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())


def resample(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    if fs_in == fs_out:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(fs_in, fs_out)
    return resample_poly(x, fs_out // g, fs_in // g).astype(np.float32)


def trim_silence(
    x: np.ndarray,
    top_db: float = 30.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> Tuple[int, int]:
    """(start, end) sample indices of the non-silent span,
    librosa.effects.trim-compatible (threshold: frame RMS power less
    than peak - top_db)."""
    if len(x) == 0:
        return 0, 0
    pad = frame_length // 2
    xp = np.pad(np.abs(x).astype(np.float64), (pad, pad))
    n_frames = 1 + (len(xp) - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    frames = xp[idx]
    rms = np.sqrt(np.mean(frames * frames, axis=1))
    ref = rms.max()
    if ref <= 0:
        return 0, len(x)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    keep = np.flatnonzero(db > -top_db)
    if keep.size == 0:
        return 0, len(x)
    start = int(keep[0]) * hop_length
    end = min(len(x), int(keep[-1] + 1) * hop_length)
    return start, end
