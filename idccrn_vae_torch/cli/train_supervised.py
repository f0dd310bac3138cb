"""Supervised DCCRN baseline training — the reference's
supervised_dccrn/train.py surface.

The port of `idccrn_vae_tpu.cli.train_supervised`, with the same flags
and ini (configs/supervised_dccrn.ini) plus --device (default: the CUDA
card). --data_norm reads [User] mean_file / std_file (written by
cal_mean_std). It writes a port checkpoint dir (meta.json with the
datanorm, best.pt, state.pt, loss_curves.json, train.log) that the
port's test_supervised and stream_enhance read. --n_devices
trains data-parallel (`cli/common.data_parallel`).
"""

from __future__ import annotations

import argparse

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
from idccrn_vae_torch.losses.phase2 import EteTrainSeLoss
from idccrn_vae_torch.parallel import distributed
from idccrn_vae_torch.train.supervised import SupervisedTrainer
from idccrn_vae_torch.utils.config import load_ini


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_common_train_flags(p)
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
    cfg = model_config(args, ini, skip_mode="real")
    datanorm = datanorm_from_ini(ini, args.data_norm)
    loss = EteTrainSeLoss(parse_weights(args.recon_loss_weight))
    trainer = SupervisedTrainer(
        cfg, loss, learning_rate=float(ini.get("Training", "lr")),
        datanorm=datanorm, seed=args.seed, device=device)
    train_loader, val_loader, n_train, n_val = loaders_from_ini(
        ini, "pair", args.first_use_dataset)
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
        model_name=model_name, resume=args.reload, logger=logger)
    return curves, best, save_dir


if __name__ == "__main__":
    main()
