"""Test-set file discovery: the evaluation part of
`idccrn_vae_tpu/data/segments.py`.

`find_wavs` enumerates a directory (sorted walk) or a .txt file list;
`companion_paths` locates the clean/noise companions of a DNS-style
noisy file: ``*_fileid_<id>.wav`` -> ``clean_fileid_<id>.wav`` /
``noise_fileid_<id>.wav`` (dataload_nsvae.py:177-192). The segment
index and `SegmentDataset` belong to training and are not ported yet.
"""

from __future__ import annotations

import os
from typing import List


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
