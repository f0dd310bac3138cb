"""Supervised DCCRN baseline training (supervised_dccrn/train.py:47).

The port of `idccrn_vae_tpu/train/supervised.py`: the weighted
cpx-MSE + mag-MSE + SI-SNR loss (ete_train_se_loss, nsvae_loss.py:
755-806) on (noisy -> clean) pairs. The target spectrogram is the bare
STFT of the clean waveform, and the prediction is de-normalized when the
model runs with datanorm; the clean waveform is cut to the estimate's
(ISTFT) length.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.losses.phase2 import EteTrainSeLoss
from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.models.dccrn import SupervisedDccrn
from idccrn_vae_torch.train.checkpoint import datanorm_to_meta
from idccrn_vae_torch.train.loop import Trainer
from idccrn_vae_torch.train.optim import PlateauScheduler, make_adam


class SupervisedTrainer(Trainer):
    """Runs on the CUDA card unless `device` names another device; the
    weights are drawn from a CPU generator seeded with `seed`.

    In a data-parallel group a train step averages the gradients with
    one flattened all-reduce after the backward (`reduce_gradients`)."""

    def __init__(self, cfg: DccrnConfig, loss: EteTrainSeLoss,
                 learning_rate: float, weight_decay: float = 1e-3,
                 datanorm: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 seed: int = 123, device: DeviceLike = None):
        self.device = resolve_device(device)
        cfg.reject_int8_training("SupervisedTrainer")
        self.cfg = cfg
        self.loss = loss
        self.datanorm = datanorm  # kept host-side for meta.json
        self.seed = seed
        self.model = SupervisedDccrn(
            cfg, datanorm, device=self.device,
            generator=torch.Generator().manual_seed(seed))
        self.opt = make_adam(self.model.parameters(), learning_rate,
                             weight_decay)
        self.sched = PlateauScheduler(0.5, 3)

    @property
    def models(self):
        return {"model": self.model}

    @property
    def optimizers(self):
        return {"opt": self.opt}

    @property
    def schedulers(self):
        return {"sched": (self.sched, "opt")}

    def best_snapshot(self):
        """The supervised family's best.pt is the bare state_dict (the
        JAX package saves the model's variables)."""
        return self.model.state_dict()

    def meta_fields(self) -> dict:
        # reference equivalent: the 'datanorm=' dir-name flag + config
        # mean_file (supervised_dccrn/test.py:404-413)
        return {"config": dataclasses.asdict(self.cfg),
                "datanorm": datanorm_to_meta(self.datanorm)}

    def _losses(self, batch, train: bool):
        noisy, clean = self.batch_to_device(tuple(batch))
        self.model.train(train)
        est, predict = self.model(noisy)
        total, l_cpx, l_mag, l_snr = self.loss(
            predict, self.model.stft_clean(clean), clean[:, : est.shape[1]],
            est)
        metrics = {"total": total, "cpx": l_cpx, "mag": l_mag,
                   "sisnr": l_snr}
        return total, {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch, generator: Optional[torch.Generator],
                   epoch: int):
        """One update on a (noisy, clean) batch, each (B, L); returns the
        metrics as 0-dim tensors on the device, and leaves each
        parameter's gradient in `.grad`. The model draws no noise:
        `generator` is unused."""
        total, metrics = self._losses(batch, True)
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        self.reduce_gradients(self.opt)
        self.opt.step()
        return metrics

    @torch.no_grad()
    def eval_step(self, batch, generator: Optional[torch.Generator],
                  epoch: int):
        return self._losses(batch, False)[1]

    def fit(self, train_loader, val_loader, epochs: int, save_dir: str,
            early_stop_patience: int = 30, save_frequency: int = 10,
            model_name: str = "supervised_dccrn", resume: bool = False,
            logger=None):
        return super().fit(train_loader, val_loader, epochs, save_dir,
                           early_stop_patience, save_frequency, model_name,
                           resume, logger)
