"""DNSMOS reference-free MOS scoring (DNSMOS/dnsmos_local.py equivalent)
on a torch device.

Runs the DNSMOS ONNX models (SIG/BAK/OVR primary + P.808 model) over
9.01 s windows hopped by 1 s, with the published polynomial score
mapping, as the JAX package's eval/dnsmos.py does. The .onnx files
(opaque pretrained artifacts the reference also consumes as-is) ship
under idccrn_vae_torch/assets/dnsmos/ and run through the port's graph
runner (eval/onnx_exec.py): on the card by default, at full float32.

The P.808 model's mel-spectrogram features (librosa melspectrogram,
n_mels=120, n_fft=321, hop=160, power->dB ref=max, (x+40)/40) are
computed on the host in numpy (librosa-compatible slaney mel
filterbank).
"""

from __future__ import annotations

import concurrent.futures
import csv
import functools
import os
from typing import Optional

import numpy as np

from idccrn_vae_torch.device import DeviceLike
from idccrn_vae_torch.eval.onnx_exec import InferenceSession

SAMPLING_RATE = 16000
INPUT_LENGTH = 9.01

# non-personalized / personalized polynomial coefficients (highest first)
_POLY = {
    False: {
        "ovr": [-0.06766283, 1.11546468, 0.04602535],
        "sig": [-0.08397278, 1.22083953, 0.0052439],
        "bak": [-0.13166888, 1.60915514, -0.39604546],
    },
    True: {
        "ovr": [-0.00533021, 0.005101, 1.18058466, -0.11236046],
        "sig": [-0.01019296, 0.02751166, 1.19576786, -0.24348726],
        "bak": [-0.04976499, 0.44276479, -0.1644611, 0.96883132],
    },
}


def _hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(
        log_region,
        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
        mel,
    )
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                 f)
    return f


@functools.lru_cache(maxsize=4)
def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel-compatible (slaney norm) -> (n_mels, 1+n_fft//2).

    Cached: audio_melspec calls this once per 9 s scoring window of
    every file with identical arguments."""
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, len(fftfreqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights


def audio_melspec(audio: np.ndarray, n_mels: int = 120, frame_size: int = 320,
                  hop_length: int = 160, sr: int = 16000,
                  to_db: bool = True) -> np.ndarray:
    """librosa.feature.melspectrogram(n_fft=frame_size+1, hop) -> (T, n_mels)."""
    n_fft = frame_size + 1
    pad = n_fft // 2
    x = np.pad(np.asarray(audio, np.float64), (pad, pad), mode="constant")
    win = _hann_periodic(n_fft)
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(n_fft)[None, :])
    frames = x[idx] * win
    power = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2  # (T, F)
    mel = power @ mel_filterbank(sr, n_fft, n_mels).T  # (T, n_mels)
    if to_db:
        ref = np.max(mel)
        mel_db = 10.0 * np.log10(np.maximum(mel, 1e-10))
        mel_db = np.maximum(mel_db - 10.0 * np.log10(max(ref, 1e-10)), -80.0)
        mel = (mel_db + 40.0) / 40.0
    return mel.astype(np.float32)


def _hann_periodic(n):
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def default_model_paths(personalized: bool = False):
    """Paths of the bundled .onnx artifacts (assets/dnsmos/)."""
    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", "dnsmos")
    sub = "pDNSMOS" if personalized else "DNSMOS"
    return (os.path.join(base, sub, "sig_bak_ovr.onnx"),
            os.path.join(base, "DNSMOS", "model_v8.onnx"))


class ComputeScore:
    """DNSMOS scorer; mirrors ComputeScore (dnsmos_local.py:22-100).

    Both models run on `device` (CUDA unless the caller asks for another
    device) through eval/onnx_exec.py; backend "numpy" runs the plain
    numpy executor on the CPU instead."""

    def __init__(self, primary_model_path: str, p808_model_path: str,
                 device: DeviceLike = None, backend: str = "torch"):
        self.onnx_sess = InferenceSession(primary_model_path, device,
                                          backend)
        self.p808_onnx_sess = InferenceSession(p808_model_path, device,
                                               backend)

    def score_array(self, audio: np.ndarray, fs: int,
                    personalized: bool = False) -> dict:
        if fs != SAMPLING_RATE:
            from idccrn_vae_torch.data.audio_io import resample

            audio = resample(audio, fs, SAMPLING_RATE)
            fs = SAMPLING_RATE
        actual_len = len(audio)
        if actual_len == 0:
            raise ValueError(
                "empty audio — cannot score (np.append of a zero-length "
                "array would loop forever)")
        len_samples = int(INPUT_LENGTH * fs)
        while len(audio) < len_samples:
            audio = np.append(audio, audio)
        num_hops = int(np.floor(len(audio) / fs) - INPUT_LENGTH) + 1
        hop = fs
        raw = {"sig": [], "bak": [], "ovr": []}
        mapped = {"sig": [], "bak": [], "ovr": []}
        p808_scores = []
        coef = _POLY[personalized]
        for i in range(num_hops):
            seg = audio[int(i * hop): int((i + INPUT_LENGTH) * hop)]
            if len(seg) < len_samples:
                continue
            feats = seg.astype(np.float32)[None, :]
            p808_feats = audio_melspec(seg[:-160])[None, :, :]
            p808 = self.p808_onnx_sess.run(
                None, {"input_1": p808_feats})[0][0][0]
            sig_r, bak_r, ovr_r = self.onnx_sess.run(
                None, {"input_1": feats})[0][0]
            raw["sig"].append(sig_r)
            raw["bak"].append(bak_r)
            raw["ovr"].append(ovr_r)
            mapped["sig"].append(np.polyval(coef["sig"], sig_r))
            mapped["bak"].append(np.polyval(coef["bak"], bak_r))
            mapped["ovr"].append(np.polyval(coef["ovr"], ovr_r))
            p808_scores.append(p808)
        return {
            "len_in_sec": actual_len / fs,
            "sr": fs,
            "num_hops": num_hops,
            "OVRL_raw": float(np.mean(raw["ovr"])),
            "SIG_raw": float(np.mean(raw["sig"])),
            "BAK_raw": float(np.mean(raw["bak"])),
            "OVRL": float(np.mean(mapped["ovr"])),
            "SIG": float(np.mean(mapped["sig"])),
            "BAK": float(np.mean(mapped["bak"])),
            "P808_MOS": float(np.mean(p808_scores)),
        }

    def __call__(self, fpath: str, sampling_rate: int = SAMPLING_RATE,
                 personalized: bool = False) -> dict:
        from idccrn_vae_torch.data.audio_io import read_wav

        audio, fs = read_wav(fpath)
        if audio.ndim > 1:
            audio = audio[:, 0]
        out = self.score_array(audio, fs, personalized)
        out["filename"] = fpath
        return out


def write_csv(rows, csv_path: str) -> None:
    """The CSV pandas' DataFrame(rows).to_csv writes: an unnamed index
    column, then the rows' keys in first-seen order."""
    columns = []
    for r in rows:
        columns += [k for k in r if k not in columns]
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + columns)
        for i, r in enumerate(rows):
            w.writerow([i] + [_csv_cell(r.get(k)) for k in columns])


def _csv_cell(v):
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return v


def score_directory(testset_dir: str, primary_model_path: str,
                    p808_model_path: str, csv_path: Optional[str] = None,
                    personalized: bool = False, workers: int = 4,
                    device: DeviceLike = None, backend: str = "torch"):
    """Score every wav under a directory, in find_wavs order; optional
    CSV output. The pool's threads read the wavs and compute the host
    features; the graph runs take the executor's lock one at a time."""
    from idccrn_vae_torch.data.segments import find_wavs

    scorer = ComputeScore(primary_model_path, p808_model_path, device,
                          backend)
    clips = find_wavs(testset_dir)
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        rows = list(ex.map(lambda c: scorer(c, SAMPLING_RATE, personalized),
                           clips))
    if csv_path:
        write_csv(rows, csv_path)
    return rows
