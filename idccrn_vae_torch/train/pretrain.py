"""CVAE / NVAE pretraining (the reference's GRU_VAE_Train, train.py:54).

The port of `idccrn_vae_tpu/train/pretrain.py`: one step runs the
encoder and decoder in train mode (batch-statistics BN with its running
update), the loss, autograd and two Adam updates; the epoch loop,
plateau schedulers, early stop and checkpoints are `train/loop.py`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.models.vae import VaeDecoder, VaeEncoder
from idccrn_vae_torch.train.checkpoint import datanorm_to_meta
from idccrn_vae_torch.train.loop import Trainer
from idccrn_vae_torch.train.optim import PlateauScheduler, make_adam
from idccrn_vae_torch.utils.profiling import span


def tile_samples(x: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B, ...) -> (B*S, ...) sample-major within the batch."""
    return x.repeat_interleave(num_samples, dim=0)


class PretrainTrainer(Trainer):
    """Trains a VaeEncoder / VaeDecoder pair on single-signal batches
    (clean speech for a CVAE, noise for an NVAE).

    Runs on the CUDA card unless `device` names another device; the
    weights are drawn from CPU generators seeded with `seed` and
    `seed + 1`, the per-epoch noise from generators on `device`
    (`train/loop.epoch_generator`). In a data-parallel group the two
    models' gradients are averaged over the ranks after the backward,
    one flattened all-reduce per optimizer (`Trainer.reduce_gradients`).
    """

    def __init__(self, cfg: DccrnConfig, loss: PretrainVaeLoss,
                 learning_rate: float, weight_decay: float = 1e-3,
                 datanorm: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 seed: int = 123, device: DeviceLike = None):
        self.device = resolve_device(device)
        cfg.reject_int8_training("PretrainTrainer")
        self.cfg = cfg
        self.loss = loss
        self.datanorm = datanorm  # kept host-side for meta.json
        self.seed = seed
        gen = lambda k: torch.Generator().manual_seed(seed + k)
        self.encoder = VaeEncoder(cfg, datanorm, device=self.device,
                                  generator=gen(0))
        self.decoder = VaeDecoder(cfg, datanorm, device=self.device,
                                  generator=gen(1))
        self.opt_en = make_adam(self.encoder.parameters(), learning_rate,
                                weight_decay)
        self.opt_de = make_adam(self.decoder.parameters(), learning_rate,
                                weight_decay)
        self.sched_en = PlateauScheduler(0.5, 3)
        self.sched_de = PlateauScheduler(0.5, 3)

    @property
    def models(self):
        return {"enc": self.encoder, "dec": self.decoder}

    @property
    def optimizers(self):
        return {"opt_en": self.opt_en, "opt_de": self.opt_de}

    @property
    def schedulers(self):
        return {"sched_en": (self.sched_en, "opt_en"),
                "sched_de": (self.sched_de, "opt_de")}

    best_models = ("enc", "dec")

    def meta_fields(self) -> dict:
        # the datanorm is persisted so evaluation rebuilds the same
        # forward (the reference drops it at VAE eval, test_prevae.py)
        return {"config": dataclasses.asdict(self.cfg),
                "datanorm": datanorm_to_meta(self.datanorm)}

    def _losses(self, wav: torch.Tensor, generator, kl_w: float,
                skip_coin=None, noise=None):
        s = self.cfg.num_samples
        out = self.encoder(wav, generator=generator, noise=noise)
        recon, predict = self.decoder(out.stft_x, out.z, out.skips,
                                      generator=generator,
                                      skip_coin=skip_coin)
        # the waveform target trimmed to the ISTFT length ((T-1)*hop)
        wav_t = tile_samples(wav, s)[:, : recon.shape[1]]
        lo = self.loss(wav_t, recon, tile_samples(out.stft_x, s), predict,
                       out.gauss, out.z, kl_w)
        metrics = {"total": lo.total, "recon": lo.recon, "kl": lo.kl,
                   "mi": lo.mi, "cpx": lo.loss_cpx, "mag": lo.loss_mag,
                   "sisnr": lo.loss_sisnr}
        return lo.total, {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch, generator: Optional[torch.Generator],
                   epoch: int, skip_coin=None, noise=None):
        """One update of both models on `batch` (B, L); returns the
        metrics as 0-dim tensors on the device, and leaves each
        parameter's gradient in `.grad`. skip_coin injects skip_mode
        'prob''s coin (see `VaeDecoder.forward`), noise the latent draws
        (see `VaeEncoder.forward`)."""
        with span("idccrn.train.step"):
            with span("idccrn.copy_in"):
                wav = self.batch_to_device(batch)
            self.encoder.train()
            self.decoder.train()
            with span("idccrn.train.forward"):
                total, metrics = self._losses(wav, generator,
                                              self.loss.kl_weight_at(epoch),
                                              skip_coin, noise)
            self.opt_en.zero_grad(set_to_none=True)
            self.opt_de.zero_grad(set_to_none=True)
            with span("idccrn.train.backward"):
                total.backward()
            with span("idccrn.train.optimizer"):
                self.reduce_gradients(self.opt_en)
                self.reduce_gradients(self.opt_de)
                self.opt_en.step()
                self.opt_de.step()
            return metrics

    @torch.no_grad()
    def eval_step(self, batch, generator: Optional[torch.Generator],
                  epoch: int):
        """Validation metrics in eval mode. The reference scores
        validation at the fully-warm KL weight whatever the epoch
        (train.py:348): the val total drives the scheduler, the best
        epoch and early stop."""
        wav = self.batch_to_device(batch)
        self.encoder.eval()
        self.decoder.eval()
        kl_w = self.loss.kl_weight_at(self.loss.kl_warm_epochs + 2)
        return self._losses(wav, generator, kl_w)[1]

    def fit(self, train_loader, val_loader, epochs: int, save_dir: str,
            early_stop_patience: int = 30, save_frequency: int = 10,
            model_name: str = "complex_CVAE", resume: bool = False,
            logger=None):
        return super().fit(train_loader, val_loader, epochs, save_dir,
                           early_stop_patience, save_frequency, model_name,
                           resume, logger)
