"""DNSMOS batch scoring CLI — DNSMOS/dnsmos_local.py surface, on the
card by default (--device)."""

from __future__ import annotations

import argparse
import os

from idccrn_vae_torch.cli.common import add_device_arg
from idccrn_vae_torch.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--testset_dir", default=".")
    p.add_argument("-o", "--csv_path", default=None)
    p.add_argument("-p", "--personalized_MOS", action="store_true")
    p.add_argument("--model_dir", default=None,
                   help="directory holding the DNSMOS .onnx files "
                        "(default: the bundled assets/dnsmos models)")
    add_device_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    from idccrn_vae_torch.eval.dnsmos import (
        default_model_paths,
        score_directory,
    )

    if args.model_dir is None:
        primary, p808 = default_model_paths(args.personalized_MOS)
    else:
        sub = "pDNSMOS" if args.personalized_MOS else "DNSMOS"
        primary = os.path.join(args.model_dir, sub, "sig_bak_ovr.onnx")
        p808 = os.path.join(args.model_dir, "DNSMOS", "model_v8.onnx")
    rows = score_directory(args.testset_dir, primary, p808,
                           csv_path=args.csv_path,
                           personalized=args.personalized_MOS,
                           device=device)
    if not args.csv_path:
        for r in rows:
            print(r)


if __name__ == "__main__":
    main()
