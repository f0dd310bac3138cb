"""Pretrained-VAE reconstruction evaluation — test_prevae.py surface.

The port of `idccrn_vae_tpu.cli.test_prevae`, with the same flags plus
--device (default: the CUDA card). It reads a port checkpoint dir
(meta.json + best.pt holding `enc` and `dec`) and rebuilds the
training-time datanorm from meta.json.
"""

from __future__ import annotations

import argparse

from idccrn_vae_torch.cli.common import add_device_arg, config_from_meta
from idccrn_vae_torch.data.segments import find_wavs
from idccrn_vae_torch.device import resolve_device
from idccrn_vae_torch.eval.runners import run_vae_reconstruction_eval
from idccrn_vae_torch.models.vae import VaeDecoder, VaeEncoder
from idccrn_vae_torch.train.checkpoint import (
    CheckpointManager,
    datanorm_from_meta,
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--test_dir", type=str, required=True,
                   help="directory of wavs to reconstruct (the reference "
                        "hardcodes dns/wsj0/demand/dnsoff lists)")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--write_wavs", action="store_true",
                   help="save the reconstructions (the reference's "
                        "test_prevae.py --save_outfiles)")
    add_device_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ckpt = CheckpointManager(args.model_dir)
    meta = ckpt.load_meta()
    cfg = config_from_meta(meta)
    best = ckpt.load_best()
    # rebuild the training-time datanorm (the reference's test_prevae
    # silently omits data_mean/std — :549-555 — and so evaluates
    # datanorm-trained models un-normalized; meta.json fixes that)
    dn = datanorm_from_meta(meta)
    enc = VaeEncoder(cfg, dn, device=device)
    enc.load_state_dict(best["enc"])
    dec = VaeDecoder(cfg, dn, device=device)
    dec.load_state_dict(best["dec"])
    return run_vae_reconstruction_eval(
        enc, dec, find_wavs(args.test_dir), args.out_dir, cfg,
        num_samples=args.num_samples, batch_size=args.batch_size,
        write_wavs=args.write_wavs,
    )


if __name__ == "__main__":
    main()
