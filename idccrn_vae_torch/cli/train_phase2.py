"""Phase-2 decoder fine-tuning, classical or --adversarial (LSGAN) — the
reference's train_second_phase_decoder.py /
train_second_phase_adversarial.py surface.

The port of `idccrn_vae_tpu.cli.train_phase2`, with the same flags and
ini (configs/two_phase_training.ini) plus --device (default: the CUDA
card). --first_phase_folder names a port NSVAE run dir (train_nsvae):
its meta.json supplies the encoder and decoder geometry and its best.pt
the noisy encoder. --load_de starts the decoder from the CVAE run (or
reference .pt file) of --pre_decoder_dir. It writes a port checkpoint
dir (meta.json, best.pt with encoder / decoder / noise_decoder / dis,
state.pt, loss_curves.json, train.log) that the port's
`test_enhance --phase 2` reads. --n_devices trains data-parallel
(`cli/common.data_parallel`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from idccrn_vae_torch.cli.common import (
    add_common_train_flags,
    data_parallel,
    config_from_meta,
    load_pretrained_variables,
    loaders_from_ini,
    parse_weights,
    resolve_save_dir,
    train_logger,
)
from idccrn_vae_torch.device import resolve_device
from idccrn_vae_torch.losses.phase2 import TwoPhaseLoss
from idccrn_vae_torch.parallel import distributed
from idccrn_vae_torch.train.checkpoint import CheckpointManager
from idccrn_vae_torch.train.phase2 import DECODE_UPDATES, Phase2Trainer
from idccrn_vae_torch.utils.config import load_ini


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_train_flags(p)
    p.add_argument("--first_phase_folder", type=str, required=True,
                   help="NSVAE checkpoint dir (meta.json supplies configs)")
    p.add_argument("--use_sc_phase2", action="store_true")
    p.add_argument("--load_de", action="store_true",
                   help="initialize decoder from the pretrained CVAE "
                        "decoder checkpoint")
    p.add_argument("--pre_decoder_dir", type=str, default=None)
    p.add_argument("--decode_update", type=str, default="all_decode",
                   choices=list(DECODE_UPDATES))
    p.add_argument("--latent_num", type=int, default=1)
    p.add_argument("--adversarial", action="store_true")
    p.add_argument("--dlr", type=float, default=1e-4)
    p.add_argument("--d_step", type=int, default=1)
    p.add_argument("--alpha", type=float, default=1.0)
    return p


def main(argv=None):
    """Returns (curves of the epochs run, best val loss, run dir): in a
    data-parallel run, rank 0's."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ini = load_ini(args.cfg_file)
    if args.load_de and not args.pre_decoder_dir:
        raise SystemExit("--load_de requires --pre_decoder_dir (the "
                         "pretrained CVAE decoder to initialize from); "
                         "without it the fine-tune would silently start "
                         "from a random decoder")
    # checked before any CheckpointManager, whose constructor makes the
    # directory: a mistyped path must not leave an empty dir behind
    folder = args.first_phase_folder
    if not os.path.exists(os.path.join(folder, "meta.json")):
        raise SystemExit(f"--first_phase_folder {folder} holds no NSVAE "
                         "checkpoint (meta.json missing)")
    if not os.path.exists(os.path.join(folder, "best.pt")):
        raise SystemExit(f"{folder} has no best snapshot — refusing to "
                         "fine-tune from nothing")
    return data_parallel(main, argv, args.n_devices,
                         ini.getint("DataFrame", "batch_size"), device,
                         lambda: _train(args, ini, device))


def _train(args, ini, device):
    nsvae_ckpt = CheckpointManager(args.first_phase_folder)
    nsvae_meta = nsvae_ckpt.load_meta()
    enc_cfg = dataclasses.replace(config_from_meta(nsvae_meta,
                                                   "noisy_config"),
                                  num_samples=args.num_samples)
    dec_cfg = dataclasses.replace(
        config_from_meta(nsvae_meta, "pre_config"),
        skip_mode="runtime" if args.use_sc_phase2 else "none",
        recon_type=args.recon_type,
        resynthesis=args.resynthesis,
        num_samples=args.num_samples,
        latent_num=args.latent_num,
    )

    loss = TwoPhaseLoss(parse_weights(args.recon_loss_weight),
                        alpha=args.alpha, latent_num=args.latent_num)
    trainer = Phase2Trainer(
        enc_cfg, dec_cfg, loss,
        learning_rate=float(ini.get("Training", "lr")),
        adversarial=args.adversarial, dis_lr=args.dlr, d_step=args.d_step,
        decode_update=args.decode_update, seed=args.seed, device=device)
    pretrained = {"encoder": nsvae_ckpt.load_best()["noisy_enc"]}
    if args.load_de:
        pretrained["decoder"] = load_pretrained_variables(
            args.pre_decoder_dir, "vae_decoder", dec_cfg, "dec")

    train_loader, val_loader, n_train, n_val = loaders_from_ini(
        ini, "triplet", args.first_use_dataset)
    model_name = ini.get("User", "model_name")
    save_dir = resolve_save_dir(args, ini, model_name)
    logger = train_logger(save_dir)
    logger.info("train %d, val %d segments -> %s on %s, data-parallel "
                "world %d", n_train, n_val, save_dir, device,
                distributed.world())
    curves, best = trainer.fit(
        train_loader, val_loader,
        epochs=ini.getint("Training", "epochs"),
        save_dir=save_dir,
        early_stop_patience=ini.getint("Training", "early_stop_patience"),
        save_frequency=ini.getint("Training", "save_frequency"),
        model_name=model_name, resume=args.reload, logger=logger,
        pretrained=pretrained)
    return curves, best, save_dir


if __name__ == "__main__":
    main()
