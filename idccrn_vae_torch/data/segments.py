"""Segment index + datasets for single / pair / triplet corpora.

The port's copy of `idccrn_vae_tpu/data/segments.py` (the reference's
dataset/dataload_{pretrained_vaes,supervised_dccrn,nsvae}.py as one
parameterized dataset): enumerate wavs (dir or .txt list), optional
silence trim, chop into fixed windows of (sequence_len - 1) * hop
samples, cache the index to JSON. The same files, geometry and seed give
the same index as the JAX package, in the same order.

`find_wavs` enumerates a directory (sorted walk) or a .txt file list;
`companion_paths` locates the clean/noise companions of a DNS-style
noisy file: ``*_fileid_<id>.wav`` -> ``clean_fileid_<id>.wav`` /
``noise_fileid_<id>.wav`` (dataload_nsvae.py:177-192).
"""

from __future__ import annotations

import json
import os
import random
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

from idccrn_vae_torch.data.audio_io import read_wav, trim_silence


def find_wavs(path: str, suffix: str = "wav") -> List[str]:
    """Directory walk (sorted) or .txt file list."""
    if path.endswith(".txt"):
        out = []
        with open(path) as f:
            for line in f:
                line = line.rstrip()
                if line.endswith("." + suffix):
                    out.append(line)
        return out
    out = []
    for root, _dirs, files in os.walk(path):
        for fn in sorted(files):
            if fn.endswith("." + suffix):
                out.append(os.path.join(root, fn))
    return sorted(out)


def companion_paths(noisy_path: str, clean_dir: str, noise_dir: str):
    """Locate the clean/noise files for a DNS-style noisy filename
    ('*_fileid_<id>.wav', dataload_nsvae.py:177-192)."""
    base = os.path.basename(noisy_path)
    if "_fileid_" not in base:
        raise ValueError(
            f"{base!r} does not follow the DNS '*_fileid_<id>' naming "
            "convention, so its clean/noise companions cannot be "
            "located; rename the corpus or use same-basename pairing")
    file_id = base.split("_fileid_")[-1]
    return (
        os.path.join(clean_dir, f"clean_fileid_{file_id}"),
        os.path.join(noise_dir, f"noise_fileid_{file_id}"),
    )


def build_segment_index(
    file_list: Sequence[str],
    sequence_len: int,
    hop: int,
    fs: int,
    trim: bool = True,
    cache_path: Optional[str] = None,
    use_cache: bool = False,
    shuffle: bool = True,
    seed: int = 123,
    legacy_cache_paths: Sequence[str] = (),
) -> List[Tuple[str, int, int]]:
    """List of (wavfile, start, end) windows of (sequence_len-1)*hop
    samples, mirroring SpeechSequencesFull.compute_len
    (dataload_pretrained_vaes.py:123-161).

    The cache is validated against every index-determining parameter
    (file list, sequence_len, hop, trim, shuffle, seed): the reference's
    pkl cache is keyed only by the first_use flag, so changing the
    window geometry or corpus silently reused a stale index — here a
    mismatch rebuilds instead. `legacy_cache_paths` are additional
    READ-ONLY locations (e.g. the pre-round-4 CWD cache spot) consulted
    when `cache_path` has no valid entry; writes only ever go to
    `cache_path`."""
    import hashlib

    cache_key = {
        "files": hashlib.sha1(
            "\n".join(sorted(file_list)).encode()).hexdigest(),
        "sequence_len": int(sequence_len),
        "hop": int(hop),
        "trim": bool(trim),
        "shuffle": bool(shuffle),
        "seed": int(seed),
    }
    if use_cache:
        candidates = ([cache_path] if cache_path else []) + list(
            legacy_cache_paths)
        for cand in candidates:
            if not (cand and os.path.exists(cand)):
                continue
            try:
                with open(cand) as f:
                    cached = json.load(f)
            except (ValueError, OSError):
                continue  # truncated/corrupt cache -> rebuild, not crash
            if isinstance(cached, dict) and cached.get("key") == cache_key:
                return [tuple(e) for e in cached["index"]]
            # legacy bare-list caches carry no key -> also rebuilt

    seg_samples = (sequence_len - 1) * hop
    index: List[Tuple[str, int, int]] = []
    for wavfile in file_list:
        x, fs_x = read_wav(wavfile)
        if x.ndim > 1:
            x = x[:, 0]
        if fs_x != fs:
            raise ValueError(
                f"unexpected sampling rate {fs_x} (want {fs}): {wavfile}")
        if trim:
            beg, end = trim_silence(x, top_db=30.0)
        else:
            beg, end = 0, len(x)
        file_len = end - beg
        n_seq = (1 + file_len // hop) // sequence_len
        for i in range(n_seq):
            index.append((wavfile, i * seg_samples + beg,
                          (i + 1) * seg_samples + beg))
    if shuffle:
        random.Random(seed).shuffle(index)
    if cache_path:
        try:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            # atomic write: the cache lives in a SHARED corpus dir, so a
            # concurrent reader (multi-host worker) must never see a
            # half-written file
            tmp = f"{cache_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"key": cache_key, "index": index}, f)
            os.replace(tmp, cache_path)
        except OSError as e:  # e.g. read-only corpus mount — index still valid
            warnings.warn(f"could not write segment-index cache "
                          f"{cache_path}: {e}")
    return index


class SegmentDataset:
    """Maps a segment index to waveform windows.

    mode 'single'  -> x (clean or noise pretraining)
    mode 'pair'    -> (noisy, clean)
    mode 'triplet' -> (noisy, clean, noise)
    For pair/triplet the index is built over the NOISY corpus and
    companions are resolved by the DNS filename convention.
    """

    def __init__(self, index, mode: str = "single",
                 clean_dir: Optional[str] = None,
                 noise_dir: Optional[str] = None):
        self.index = list(index)
        self.mode = mode
        self.clean_dir = clean_dir
        self.noise_dir = noise_dir

    def __len__(self) -> int:
        return len(self.index)

    def _slice(self, path: str, start: int, end: int) -> np.ndarray:
        x, _fs = read_wav(path)
        if x.ndim > 1:
            x = x[:, 0]
        seg = x[start:end]
        if len(seg) < end - start:  # guard ragged tails
            seg = np.pad(seg, (0, end - start - len(seg)))
        return seg.astype(np.float32)

    def __getitem__(self, i: int):
        path, start, end = self.index[i]
        noisy = self._slice(path, start, end)
        if self.mode == "single":
            return noisy
        clean_p, noise_p = companion_paths(path, self.clean_dir or "",
                                           self.noise_dir or "")
        clean = self._slice(clean_p, start, end)
        if self.mode == "pair":
            return noisy, clean
        noise = self._slice(noise_p, start, end)
        return noisy, clean, noise
