"""Speech-like synthetic corpus generation (host-side numpy).

The port's copy of `idccrn_vae_tpu/data/synth.py`: the same seed gives
byte-identical wavs and an equal `corpus_meta.json`.

The reference evaluates on real corpora (DNS3 / WSJ0-QUT / VB-DMD, the
reference's results/*.png) that are not redistributable with the code.
This module generates a SPEECH-LIKE surrogate corpus so that end-to-end
training demos produce *interpretable* quality metrics (STOI/ESTOI and
PESQ both model speech: without formant structure, silences and a
voiced/unvoiced distinction their numbers are noise — an earlier E2E
demo's meaningless ESTOI deltas were the motivating failure).

"Speech" = a source-filter model: a voiced harmonic source with f0
declination/jitter/vibrato and an unvoiced (fricative) noise source,
gated by a phone/word/pause structure with REAL silences, filtered by
three formant resonators whose center frequencies follow per-phone
targets with smooth trajectories. "Noise" = stationary (white+pink) or
nonstationary (amplitude-modulated pink) draws. Mixing follows the
reference's evaluation protocol shape (DNS3-style SNR buckets,
BASELINE.md): each utterance is assigned a bucket round-robin (so per-
bucket medians are computed over balanced groups) and a uniform SNR
within it, defined against the ACTIVE-speech level (energy within
26 dB of the utterance peak, ~ITU P.56 active speech level) so that
pause density does not dilute the nominal SNR.

File naming follows the DNS companion convention the data loader pairs
by ({clean,noise,noisy}_fileid_<i>.wav; see data/segments.py), and
`corpus_meta.json` records per-file SNR/bucket/noise-kind for bucketed
reporting (eval/report.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

FS = 16000

#: DNS3-style 5 dB evaluation buckets (BASELINE.md rows; the reference's
#: results figures report per-bucket box plots over [0, 20] dB).
SNR_BUCKETS: Tuple[Tuple[float, float], ...] = (
    (0.0, 5.0), (5.0, 10.0), (10.0, 15.0), (15.0, 20.0))

_HOP = 160  # 10 ms synthesis frames at 16 kHz


def bucket_label(lo: float, hi: float) -> str:
    return f"[{lo:g},{hi:g})"


def _resonator(fc: float, r: float, fs: int):
    th = 2.0 * np.pi * fc / fs
    return np.array([1.0 - r]), np.array([1.0, -2.0 * r * np.cos(th),
                                          r * r])


def _tv_resonate(x: np.ndarray, fc_frames: np.ndarray, r: float,
                 fs: int) -> np.ndarray:
    """Time-varying 2-pole resonator: per-10ms-frame coefficients,
    filter state carried across frames (the standard block approach —
    scipy has no native time-varying IIR)."""
    from scipy.signal import lfilter

    out = np.empty_like(x)
    zi = np.zeros(2)
    for i in range(0, len(x), _HOP):
        fc = fc_frames[min(i // _HOP, len(fc_frames) - 1)]
        b, a = _resonator(fc, r, fs)
        out[i:i + _HOP], zi = lfilter(b, a, x[i:i + _HOP], zi=zi)
    return out


def _smooth_frames(track: np.ndarray, width: int = 5) -> np.ndarray:
    """Moving-average smoothing of a per-frame track (formant/gain
    trajectories transition over ~width*10 ms, like articulator motion)."""
    k = np.ones(width) / width
    return np.convolve(np.pad(track, (width // 2, width // 2),
                              mode="edge"), k, mode="valid")[:len(track)]


def _phone_plan(rng: np.random.Generator, n_frames: int):
    """Word/phone/pause segmentation.

    Words of 2-5 phones (60-180 ms each, voiced with p=.72 else
    unvoiced), separated by pauses: real silences of 120-400 ms with
    p=.6, else short 10-40 ms gaps. Returns per-frame (voiced, unvoiced,
    F1, F2, F3, gain) tracks — silence has gain 0.
    """
    voiced = np.zeros(n_frames, bool)
    unvoiced = np.zeros(n_frames, bool)
    gain = np.zeros(n_frames)
    f1 = np.full(n_frames, 500.0)
    f2 = np.full(n_frames, 1500.0)
    f3 = np.full(n_frames, 2700.0)
    t = 0
    # lead-in silence so utterances don't all start mid-word
    t += int(rng.integers(2, 10))
    while t < n_frames:
        for _ in range(int(rng.integers(2, 6))):  # phones in this word
            dur = int(rng.integers(6, 19))        # 60-180 ms
            end = min(t + dur, n_frames)
            if end <= t:
                break
            if rng.random() < 0.72:
                voiced[t:end] = True
            else:
                unvoiced[t:end] = True
            gain[t:end] = rng.uniform(0.45, 1.0)
            f1[t:end] = rng.uniform(260, 850)
            f2[t:end] = rng.uniform(900, 2300)
            f3[t:end] = rng.uniform(2350, 3300)
            t = end
        # pause between words
        if rng.random() < 0.6:
            t += int(rng.integers(12, 41))        # 120-400 ms silence
        else:
            t += int(rng.integers(1, 5))          # 10-40 ms gap
    return voiced, unvoiced, gain, f1, f2, f3


def synth_speech(rng: np.random.Generator, n: int, fs: int = FS
                 ) -> np.ndarray:
    """One speech-like utterance of n samples (peak-normalized to 0.3)."""
    n_frames = (n + _HOP - 1) // _HOP
    voiced, unvoiced, gain, f1, f2, f3 = _phone_plan(rng, n_frames)
    # smooth articulation: gains ramp over ~30 ms, formants glide ~50 ms
    g_frames = _smooth_frames(gain * voiced, 3)
    uv_frames = _smooth_frames(gain * unvoiced, 3)
    f1, f2, f3 = (_smooth_frames(f, 5) for f in (f1, f2, f3))

    t = np.arange(n) / fs
    # f0 track: base + declination + slow wander + vibrato + jitter
    base = rng.uniform(95, 240)
    f0 = base * (1.0
                 - 0.06 * t / max(t[-1], 1e-9)
                 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t
                                 + rng.uniform(0, 2 * np.pi))
                 + 0.015 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t))
    f0 = f0 * (1.0 + 0.01 * np.repeat(
        rng.standard_normal(n_frames), _HOP)[:n])
    phase = 2 * np.pi * np.cumsum(f0) / fs
    # harmonic-rich glottal-ish source (1/k rolloff, 12 harmonics < 3 kHz)
    src = sum(np.sin(k * phase) / k for k in range(1, 13))
    g = np.repeat(g_frames, _HOP)[:n]
    voiced_exc = src * g

    # formant cascade on the voiced source
    sp = _tv_resonate(voiced_exc, f1, 0.97, fs)
    sp = _tv_resonate(sp, f2, 0.965, fs)
    sp = _tv_resonate(sp, f3, 0.96, fs)

    # unvoiced (fricative) source: tilted noise through one high resonator
    uv = np.repeat(uv_frames, _HOP)[:n]
    if uv.any():
        noise = np.diff(rng.standard_normal(n + 1))  # +6 dB/oct tilt
        fric_fc = np.full(n_frames, rng.uniform(2800, 5800))
        sp = sp + 0.35 * _tv_resonate(noise * uv, fric_fc, 0.92, fs)

    return (0.3 * sp / (np.abs(sp).max() + 1e-9)).astype(np.float32)


def synth_noise(rng: np.random.Generator, n: int, fs: int = FS,
                kind: Optional[str] = None) -> Tuple[np.ndarray, str]:
    """One noise draw. kind ∈ {'static', 'modpink'} (random if None):
    'static' = white+pink mixture, 'modpink' = pink with slow random
    amplitude modulation (nonstationary, like traffic/wind swells)."""
    if kind is None:
        kind = "static" if rng.random() < 0.5 else "modpink"
    w = rng.standard_normal(n)
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.maximum(np.fft.rfftfreq(n, 1 / fs), 1.0)
    pink = np.fft.irfft(spec / np.sqrt(f), n)
    pink = pink / (np.abs(pink).max() + 1e-9)
    if kind == "static":
        x = w / np.abs(w).max() + 2.0 * pink
    else:
        # deep slow swells: log-uniform control points every ~0.5 s
        # (up to 26 dB dynamic range), linearly interpolated
        n_frames = (n + _HOP - 1) // _HOP
        ctrl = rng.uniform(np.log(0.05), 0.0, max(n_frames // 50, 2) + 1)
        env = np.exp(np.interp(np.arange(n_frames),
                               np.linspace(0, n_frames - 1, len(ctrl)),
                               ctrl))
        x = pink * np.repeat(env, _HOP)[:n] + 0.02 * w / np.abs(w).max()
    return (0.3 * x / (np.abs(x).max() + 1e-9)).astype(np.float32), kind


def active_rms(x: np.ndarray, rel_db: float = 26.0) -> float:
    """RMS over active 10 ms frames (within rel_db of the loudest frame),
    ~ITU P.56 active speech level — keeps pause density out of the
    nominal SNR."""
    n_fr = len(x) // _HOP
    if n_fr == 0:  # shorter than one frame -> plain RMS
        return float(np.sqrt((x ** 2).mean()) + 1e-12)
    fe = (x[:n_fr * _HOP].reshape(n_fr, _HOP) ** 2).mean(axis=1)
    thresh = fe.max() * 10 ** (-rel_db / 10)
    act = fe[fe >= thresh]
    return float(np.sqrt(act.mean())) if act.size else float(
        np.sqrt((x ** 2).mean()) + 1e-12)


def mix_at_snr(speech: np.ndarray, noise: np.ndarray, snr_db: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Scale noise so active-speech-level / noise-RMS = snr_db; returns
    (noisy, scaled_noise)."""
    s_rms = active_rms(speech)
    n_rms = float(np.sqrt((noise ** 2).mean()) + 1e-12)
    scaled = noise * (s_rms / (n_rms * 10 ** (snr_db / 20)))
    return (speech + scaled).astype(np.float32), scaled.astype(np.float32)


def make_corpus(root: str, n_train: int, n_val: int,
                utt_seconds: float = 6.5, fs: int = FS,
                buckets: Sequence[Tuple[float, float]] = SNR_BUCKETS,
                seed: int = 0) -> Tuple[Dict[str, str], dict]:
    """Write {clean,noise,noisy}_{train,val} dirs + corpus_meta.json.

    SNR buckets are assigned round-robin within each split (balanced
    per-bucket groups for the median report); the SNR is uniform within
    the assigned bucket. Returns (dirs, meta).
    """
    from idccrn_vae_torch.data.audio_io import write_wav

    dirs = {}
    for name in ("clean_train", "clean_val", "noise_train", "noise_val",
                 "noisy_train", "noisy_val"):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        dirs[name] = d
    n = int(utt_seconds * fs)
    meta = {"fs": fs, "utt_seconds": utt_seconds, "seed": seed,
            "snr_def": "active-speech level (P.56-like, 26 dB rel) "
                       "over noise RMS",
            "buckets": [bucket_label(*b) for b in buckets], "files": {}}
    for split, count, sub in (("train", n_train, 0), ("val", n_val, 1)):
        rng = np.random.default_rng([seed, sub])
        for i in range(count):
            sp = synth_speech(rng, n, fs)
            nz, kind = synth_noise(rng, n, fs)
            lo, hi = buckets[i % len(buckets)]
            snr = float(rng.uniform(lo, hi))
            noisy, nz_scaled = mix_at_snr(sp, nz, snr)
            write_wav(f"{dirs[f'clean_{split}']}/clean_fileid_{i}.wav",
                      sp, fs)
            write_wav(f"{dirs[f'noise_{split}']}/noise_fileid_{i}.wav",
                      nz_scaled, fs)
            write_wav(f"{dirs[f'noisy_{split}']}/noisy_fileid_{i}.wav",
                      noisy, fs)
            meta["files"][f"{split}/noisy_fileid_{i}.wav"] = {
                "snr_db": round(snr, 3), "bucket": bucket_label(lo, hi),
                "noise_kind": kind}
    with open(os.path.join(root, "corpus_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return dirs, meta
