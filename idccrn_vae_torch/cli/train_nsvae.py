"""NSVAE training — the reference's train_nsvae.py surface.

The port of `idccrn_vae_tpu.cli.train_nsvae`, with the same flags and
ini (configs/nsvae_config.ini) plus --device (default: the CUDA card).
[User] pre_clean_encoder / pre_noise_encoder name port checkpoint dirs
(their meta.json supplies the architecture) or reference .pt files
(then the architecture flags --skipc / --skip_padding / --fclatent say
it). A dir without a best snapshot is refused. --n_devices trains
data-parallel (`cli/common.data_parallel`).
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
    model_config,
    resolve_save_dir,
    train_logger,
)
from idccrn_vae_torch.device import resolve_device
from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
from idccrn_vae_torch.parallel import distributed
from idccrn_vae_torch.train.checkpoint import CheckpointManager
from idccrn_vae_torch.train.nsvae import NsvaeTrainer
from idccrn_vae_torch.utils.config import load_ini


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_train_flags(p)
    p.add_argument("--nsvae_model", type=str, default="original",
                   choices=["original", "double", "adapt"])
    p.add_argument("--latent_num", type=int, default=2)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--w_resi", type=float, default=0.0)
    p.add_argument("--w_kl", type=float, default=1.0)
    p.add_argument("--w_dismiu", type=float, default=0.0)
    p.add_argument("--matching", type=str, default="speech",
                   choices=["speech", "both"])
    p.add_argument("--fclatent", action="store_true")
    # architecture of reference .pt checkpoints, which have no meta.json
    p.add_argument("--skipc", action="store_true",
                   help="pretrained VAEs use real skip connections "
                        "(only needed with .pt checkpoints)")
    p.add_argument("--skip_padding", action="store_true",
                   help="pretrained VAEs are the 'spadd' zero-skip "
                        "family (only needed with .pt checkpoints)")
    return p


def main(argv=None):
    """Returns (curves of the epochs run, best val loss, run dir): in a
    data-parallel run, rank 0's."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ini = load_ini(args.cfg_file)
    clean_dir = ini.get("User", "pre_clean_encoder")
    noise_dir = ini.get("User", "pre_noise_encoder")
    for path in (clean_dir, noise_dir):
        if not (_is_file(path)
                or os.path.isfile(os.path.join(path, "best.pt"))):
            raise SystemExit(
                f"{path} has no 'best' snapshot — refusing to train "
                "NSVAE posterior matching against randomly initialized "
                "frozen encoders (check pre_clean_encoder / "
                "pre_noise_encoder in the ini)")
    return data_parallel(main, argv, args.n_devices,
                         ini.getint("DataFrame", "batch_size"), device,
                         lambda: _train(args, ini, device))


def _is_file(path: str) -> bool:
    return path.endswith((".pt", ".pth"))


def _train(args, ini, device):
    clean_dir = ini.get("User", "pre_clean_encoder")
    noise_dir = ini.get("User", "pre_noise_encoder")
    if _is_file(clean_dir):
        pre_cfg = model_config(args, ini)
    else:
        pre_cfg = config_from_meta(CheckpointManager(clean_dir).load_meta())

    channel_mode = {"original": "normal", "double": "double",
                    "adapt": "adapt"}[args.nsvae_model]
    noisy_cfg = dataclasses.replace(
        model_config(args, ini, latent_num=args.latent_num,
                     channel_mode=channel_mode),
        skip_to_use=pre_cfg.skip_to_use)

    loss = NsvaeTrueKlLoss(
        alpha=args.alpha, w_resi=args.w_resi, w_kl=args.w_kl,
        w_dismiu=args.w_dismiu, cfg=noisy_cfg, matching=args.matching,
        use_skips=pre_cfg.skip_mode == "real")
    trainable = {
        "clean_enc": ini.getboolean("Network", "clean_encoder"),
        "noise_enc": ini.getboolean("Network", "noise_encoder"),
    }
    trainer = NsvaeTrainer(
        pre_cfg, noisy_cfg, loss,
        learning_rate=float(ini.get("Training", "lr")),
        trainable=trainable, seed=args.seed, device=device)
    pretrained = {
        key: load_pretrained_variables(path, "vae_encoder", pre_cfg, "enc")
        for key, path in (("clean_enc", clean_dir), ("noise_enc", noise_dir))}

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
