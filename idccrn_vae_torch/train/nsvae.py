"""NSVAE training: posterior-match a noisy encoder to frozen VAEs.

The port of `idccrn_vae_tpu/train/nsvae.py` (the reference's
train_nsvae.py): the pretrained clean and noise encoders and the
trainable noisy encoder; [Network] booleans may unfreeze the pretrained
encoders. Decoders never run (pure posterior matching,
train_nsvae.py:524-536).

A frozen encoder runs in eval mode under no_grad, as the reference puts
every non-trainable model in eval() (train_nsvae.py:451-468, 485-499):
its BN normalizes with the pretrained running statistics, and its
weights and statistics stay byte-identical. One Adam covers every
trainable parameter (the same update as the reference's per-model
Adams: Adam is elementwise).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.models.modules import set_bn_counts
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeEncoder
from idccrn_vae_torch.train.loop import Trainer
from idccrn_vae_torch.train.optim import PlateauScheduler, make_adam


class NsvaeTrainer(Trainer):
    """Runs on the CUDA card unless `device` names another device. In a
    data-parallel group the trainable parameters' gradients (one Adam's)
    are averaged over the ranks in one flattened all-reduce after the
    backward; a frozen encoder has none and sends nothing."""

    def __init__(self, pre_cfg: DccrnConfig, noisy_cfg: DccrnConfig,
                 loss: NsvaeTrueKlLoss, learning_rate: float,
                 trainable: Optional[Dict[str, bool]] = None,
                 weight_decay: float = 1e-3, seed: int = 123,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        pre_cfg.reject_int8_training("NsvaeTrainer")
        noisy_cfg.reject_int8_training("NsvaeTrainer")
        self.pre_cfg = pre_cfg
        self.noisy_cfg = noisy_cfg
        self.loss = loss
        self.seed = seed
        gen = lambda k: torch.Generator().manual_seed(seed + k)
        self.models = {
            "clean_enc": VaeEncoder(pre_cfg, device=self.device,
                                    generator=gen(0)),
            "noise_enc": VaeEncoder(pre_cfg, device=self.device,
                                    generator=gen(1)),
            "noisy_enc": NsvaeEncoder(noisy_cfg, device=self.device,
                                      generator=gen(2)),
        }
        self.trainable = {"clean_enc": False, "noise_enc": False,
                          **(trainable or {})}
        params = []
        for name, m in self.models.items():
            m.requires_grad_(self._trains(name))
            if self._trains(name):
                params += list(m.parameters())
        self.opt = make_adam(params, learning_rate, weight_decay)
        self.sched = PlateauScheduler(0.5, 3)

    def _trains(self, name: str) -> bool:
        return name == "noisy_enc" or bool(self.trainable.get(name))

    @property
    def optimizers(self):
        return {"opt": self.opt}

    @property
    def schedulers(self):
        return {"sched": (self.sched, "opt")}

    best_models = ("clean_enc", "noise_enc", "noisy_enc")

    def meta_fields(self) -> dict:
        return {"pre_config": dataclasses.asdict(self.pre_cfg),
                "noisy_config": dataclasses.asdict(self.noisy_cfg),
                "trainable": self.trainable}

    def load_pretrained(self, pretrained: Dict[str, dict]) -> None:
        """Load state_dicts (name -> state_dict, e.g. from
        `cli.common.load_pretrained_variables`) into the named models.
        A state_dict carries no BN step counter; as the JAX package's
        reference importer does, the loaded statistics count as live
        (counter 1), so an unfrozen encoder blends them with its batches
        instead of replacing them."""
        for name, sd in pretrained.items():
            self.models[name].load_state_dict(sd)
            set_bn_counts(self.models[name], 1)

    def _losses(self, batch, generator, train: bool):
        noisy, clean, noise = self.batch_to_device(tuple(batch))
        outs = {}
        for name, x in (("clean_enc", clean), ("noise_enc", noise),
                        ("noisy_enc", noisy)):
            active = train and self._trains(name)
            self.models[name].train(active)
            with torch.set_grad_enabled(active):
                outs[name] = self.models[name](x, generator=generator)
        c, n, y = outs["clean_enc"], outs["noise_enc"], outs["noisy_enc"]
        lo = self.loss(c.gauss, n.gauss, y.gauss_speech, y.gauss_noise,
                       skips_clean=c.skips, skips_noise=n.skips,
                       skips_noisy=y.skips)
        metrics = {"total": lo.total, "kl": lo.kl, "kl_clean": lo.kl_clean,
                   "kl_noise": lo.kl_noise,
                   "dismiu_speech": lo.dismiu_speech,
                   "dismiu_noise": lo.dismiu_noise, "resi": lo.resi}
        return lo.total, {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch, generator: Optional[torch.Generator],
                   epoch: int):
        """One update on a (noisy, clean, noise) batch, each (B, L);
        returns the metrics as 0-dim tensors on the device, and leaves
        each trainable parameter's gradient in `.grad`."""
        total, metrics = self._losses(batch, generator, True)
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        self.reduce_gradients(self.opt)
        self.opt.step()
        return metrics

    @torch.no_grad()
    def eval_step(self, batch, generator: Optional[torch.Generator],
                  epoch: int):
        return self._losses(batch, generator, False)[1]

    def fit(self, train_loader, val_loader, epochs: int, save_dir: str,
            early_stop_patience: int = 20, save_frequency: int = 10,
            model_name: str = "complex_NSVAE", resume: bool = False,
            logger=None, pretrained: Optional[Dict[str, dict]] = None):
        """pretrained: optional name -> state_dict for the models, loaded
        before training (and overridden by the state of a resume)."""
        if pretrained:
            self.load_pretrained(pretrained)
        return super().fit(train_loader, val_loader, epochs, save_dir,
                           early_stop_patience, save_frequency, model_name,
                           resume, logger)
