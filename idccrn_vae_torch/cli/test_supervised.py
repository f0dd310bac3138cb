"""Supervised DCCRN evaluation — supervised_dccrn/test.py surface
(without the reference's debug 5-file truncation).

The port of `idccrn_vae_tpu.cli.test_supervised`, with the same flags
plus --device (default: the CUDA card). It reads a port checkpoint dir:
best.pt for --model_type checkpoint, for final the `model` of the
state.pt that `train_supervised` writes.
"""

from __future__ import annotations

import argparse

from idccrn_vae_torch.cli.common import (
    add_bucket_args,
    add_device_arg,
    bucket_kwargs,
    config_from_meta,
    match_clean_paths,
)
from idccrn_vae_torch.data.segments import find_wavs
from idccrn_vae_torch.device import resolve_device
from idccrn_vae_torch.eval.runners import run_supervised_eval
from idccrn_vae_torch.models.dccrn import SupervisedDccrn
from idccrn_vae_torch.train.checkpoint import (
    CheckpointManager,
    datanorm_from_meta,
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--model_type", type=str, default="checkpoint",
                   choices=["checkpoint", "final"],
                   help="'checkpoint' = best-val snapshot, 'final' = last "
                        "training state")
    p.add_argument("--noisy_dir", type=str, required=True)
    p.add_argument("--clean_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--write_wavs", action="store_true",
                   help="save the enhanced outputs (the reference's "
                        "supervised_dccrn/test.py --save_output)")
    add_bucket_args(p)
    add_device_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ckpt = CheckpointManager(args.model_dir)
    meta = ckpt.load_meta()
    cfg = config_from_meta(meta)
    if args.model_type == "checkpoint":
        state = ckpt.load_best()
    else:
        state = ckpt.load_state()["models"]["model"]
    # rebuild the training-time datanorm from meta (the reference
    # re-parses it from the dir name + config mean_file,
    # supervised_dccrn/test.py:404-413)
    model = SupervisedDccrn(cfg, datanorm_from_meta(meta), device=device)
    model.load_state_dict(state)
    noisy_paths = find_wavs(args.noisy_dir)
    clean_paths = match_clean_paths(noisy_paths, args.clean_dir)
    return run_supervised_eval(model, noisy_paths, clean_paths,
                               args.out_dir, cfg, batch_size=args.batch_size,
                               write_wavs=args.write_wavs,
                               **bucket_kwargs(args))


if __name__ == "__main__":
    main()
