"""Serve from an exported artifact: no checkpoint or model code.

The port of `idccrn_vae_tpu.cli.run_artifact`, with the same flags plus
--device (default: the CUDA card). It loads the `.pt2` artifact that
cli/export_model.py wrote (`eval/export.py`) and enhances a directory
of wavs; this entry point only does wav I/O, windowing to the
artifact's fixed length, batching and the latent draws, which come from
one `torch.Generator` seeded with --seed. An artifact exported on
another device than --device is moved explicitly (`load_artifact`), and
the report names both.

  python -m idccrn_vae_torch.cli.run_artifact \
      --artifact_dir artifact/ --in_dir noisy/ --out_dir enhanced/
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from idccrn_vae_torch.cli.common import add_device_arg


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--artifact_dir", type=str, required=True)
    p.add_argument("--in_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the generator the latent draws come from")
    add_device_arg(p)
    return p


def windowed_enhance(call, wavs, length: int, n_fft: int, batch_size: int):
    """Enhance each wav through `call(batch (b, w) float32 numpy) -> (b,
    w)` in fixed-`length` windows. Returns (outputs, window count).

    Adjacent windows overlap by min(n_fft, length // 2) so each window's
    head, which lacks left context, is cross-faded against the previous
    window's in-context tail (ramped weights, normalized by the summed
    weight afterwards). Windows of all files form one span list, longest
    first, so --batch_size bounds the batch in windows and short tails
    batch into the smaller buckets."""
    overlap = min(n_fft, length // 2)
    step = max(length - overlap, 1)
    spans = []  # (utterance, start, valid samples)
    for u, w in enumerate(wavs):
        start = 0
        while True:
            spans.append((u, start, max(min(length, len(w) - start), 0)))
            if start + length >= len(w):
                break
            start += step
    spans.sort(key=lambda s: -s[2])
    num = [np.zeros(len(w), np.float64) for w in wavs]
    den = [np.zeros(len(w), np.float64) for w in wavs]
    for s in range(0, len(spans), batch_size):
        group = spans[s : s + batch_size]
        width = max(1, max(v for _, _, v in group))
        batch = np.zeros((len(group), width), np.float32)
        for r, (u, start, valid) in enumerate(group):
            batch[r, :valid] = wavs[u][start : start + valid]
        out = np.asarray(call(batch))
        for r, (u, start, valid) in enumerate(group):
            v = min(valid, out.shape[1])
            if v <= 0:
                continue
            wt = np.ones(v)
            if start > 0:  # fade in against the previous window's tail
                h = min(overlap, v)
                wt[:h] = np.arange(1, h + 1) / (h + 1)
            if start + length < len(wavs[u]):  # a next window follows
                tail = min(overlap, v)
                wt[-tail:] = np.minimum(
                    wt[-tail:], np.arange(tail, 0, -1) / (tail + 1))
            num[u][start : start + v] += out[r, :v] * wt
            den[u][start : start + v] += wt
    outs = [(n / np.maximum(d, 1e-12)).astype(np.float32)
            for n, d in zip(num, den)]
    return outs, len(spans)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from idccrn_vae_torch.data.audio_io import write_wav
    from idccrn_vae_torch.data.segments import find_wavs
    from idccrn_vae_torch.device import resolve_device
    from idccrn_vae_torch.eval.export import load_artifact
    from idccrn_vae_torch.eval.runners import load_testset

    device = resolve_device(args.device)
    artifact, meta = load_artifact(args.artifact_dir, device)
    length, fs = meta["length"], meta["fs"]
    gen = torch.Generator().manual_seed(args.seed)

    paths = find_wavs(args.in_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    wavs = load_testset(paths, fs)
    t0 = time.perf_counter()
    outs, windows = windowed_enhance(
        lambda batch: artifact(batch, generator=gen).cpu().numpy(), wavs,
        length, int(meta.get("n_fft", 512)), args.batch_size)
    wall = time.perf_counter() - t0
    audio_s = 0.0
    for path, w in zip(paths, outs):
        write_wav(os.path.join(args.out_dir, os.path.basename(path)), w, fs)
        audio_s += len(w) / fs
    report = {"files": len(paths), "windows": windows,
              "audio_s": round(audio_s, 2), "wall_s": round(wall, 2),
              "rtf_x": round(audio_s / wall, 1), "device": str(device),
              "exported_on": meta["device"]}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
