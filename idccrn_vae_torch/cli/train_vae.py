"""Pretrain a CVAE (clean speech) or NVAE (noise) — the reference's
i_dccrn_vae/pretrained_vaes/train.py surface.

The port of `idccrn_vae_tpu.cli.train_vae`, with the same flags and ini
(configs/pretrained_cvae.ini, pretrained_nvae.ini) plus --device
(default: the CUDA card). It writes a port checkpoint dir (meta.json,
best.pt, state.pt, loss_curves.json, train.log) that the port's
test_prevae, train_nsvae and test_enhance read. --n_devices
trains data-parallel (`cli/common.data_parallel`).
"""

from __future__ import annotations

import argparse

import numpy as np

from idccrn_vae_torch.cli.common import (
    add_common_train_flags,
    data_parallel,
    datanorm_from_ini,
    loaders_from_ini,
    model_config,
    parse_weights,
    resolve_save_dir,
    train_logger,
)
from idccrn_vae_torch.device import resolve_device
from idccrn_vae_torch.losses.vae_loss import (
    PretrainVaeLoss,
    kl_annealing_schedule,
)
from idccrn_vae_torch.parallel import distributed
from idccrn_vae_torch.train.pretrain import PretrainTrainer
from idccrn_vae_torch.utils.config import load_ini


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_train_flags(p)
    p.add_argument("--kl_ann_flag", action="store_true")
    p.add_argument("--kl_warm_epochs", type=int, default=20)
    p.add_argument("--kl_weight", type=float, default=1.0)
    p.add_argument("--mi_weight", type=float, default=0.0)
    p.add_argument("--skipc", action="store_true")
    p.add_argument("--fclatent", action="store_true")
    p.add_argument("--skip_padding", action="store_true")
    p.add_argument("--recon_loss_type", type=str, default="multiple")
    p.add_argument("--prior_mode", type=str, default="ri_inde")
    p.add_argument("--data_norm", action="store_true")
    return p


def main(argv=None):
    """Returns (curves of the epochs run, best val loss, run dir): in a
    data-parallel run, rank 0's."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ini = load_ini(args.cfg_file)
    return data_parallel(main, argv, args.n_devices,
                         ini.getint("DataFrame", "batch_size"), device,
                         lambda: _train(args, ini, device))


def _train(args, ini, device):
    cfg = model_config(args, ini)
    datanorm = datanorm_from_ini(ini, args.data_norm)

    if args.kl_ann_flag:
        warm = kl_annealing_schedule(args.kl_warm_epochs) * args.kl_weight
    else:
        warm = np.full(0, args.kl_weight, np.float32)
    loss = PretrainVaeLoss(
        kl_warm_weights=warm,
        kl_weight=args.kl_weight,
        mi_weight=args.mi_weight,
        recon_loss_type=args.recon_loss_type,
        recon_loss_weight=parse_weights(args.recon_loss_weight),
        num_samples=args.num_samples,
        prior_mode=args.prior_mode,
    )
    trainer = PretrainTrainer(
        cfg, loss, learning_rate=float(ini.get("Training", "lr")),
        datanorm=datanorm, seed=args.seed, device=device)

    train_loader, val_loader, n_train, n_val = loaders_from_ini(
        ini, "single", args.first_use_dataset)
    model_name = ini.get("User", "model_name")
    save_dir = resolve_save_dir(args, ini, model_name)
    logger = train_logger(save_dir)
    logger.info("train %d segments, val %d segments -> %s on %s, "
                "data-parallel world %d", n_train, n_val, save_dir, device,
                distributed.world())
    curves, best = trainer.fit(
        train_loader, val_loader,
        epochs=ini.getint("Training", "epochs"),
        save_dir=save_dir,
        early_stop_patience=ini.getint("Training", "early_stop_patience"),
        save_frequency=ini.getint("Training", "save_frequency"),
        model_name=model_name,
        resume=args.reload,
        logger=logger,
    )
    return curves, best, save_dir


if __name__ == "__main__":
    main()
