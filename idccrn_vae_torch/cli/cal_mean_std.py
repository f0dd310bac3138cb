"""Offline corpus mean/std computation — the reference's
dataset/cal_mean_std.py surface.

The port of `idccrn_vae_tpu.cli.cal_mean_std`, with the same flags plus
--device (default: the CUDA card). It writes the 257x2 text files that
the training CLIs' --data_norm reads through [User] mean_file /
std_file.
"""

from __future__ import annotations

import argparse

from idccrn_vae_torch.cli.common import add_device_arg
from idccrn_vae_torch.data.segments import find_wavs
from idccrn_vae_torch.data.stats import corpus_mean_std, save_stats_txt
from idccrn_vae_torch.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--mean_out", type=str, required=True)
    p.add_argument("--std_out", type=str, required=True)
    p.add_argument("--nfft", type=int, default=512)
    p.add_argument("--hop", type=int, default=100)
    p.add_argument("--winlen", type=int, default=400)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--no_trim", action="store_true")
    add_device_arg(p)
    return p


def main(argv=None):
    """Returns (mean, std), each (F, 2)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    files = find_wavs(args.data_dir)
    mean, std = corpus_mean_std(files, args.nfft, args.hop, args.winlen,
                                trim=not args.no_trim, fs=args.fs,
                                device=device)
    save_stats_txt(args.mean_out, mean)
    save_stats_txt(args.std_out, std)
    print(f"wrote {args.mean_out} / {args.std_out} over {len(files)} files")
    return mean, std


if __name__ == "__main__":
    main()
