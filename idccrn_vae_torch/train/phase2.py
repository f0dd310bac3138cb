"""Phase-2 decoder fine-tuning: classical and adversarial (LSGAN).

The port of `idccrn_vae_tpu/train/phase2.py` (the reference's
train_second_phase_decoder.py / train_second_phase_adversarial.py).

Classical: the frozen NSVAE noisy encoder (eval mode, under no_grad)
feeds the trainable clean decoder, and with latent_num 2 a noise decoder,
with real skips (pad_mode 'sig'); the loss is the reconstruction of clean
speech (and noise). decode_update 'skip_layer' trains only the decoder
stages that mirror `skip_to_use` (stage n - 1 - i, in the noise decoder
too); the rest of each decoder is left out of Adam, which is the JAX
package's masked gradients and updates (weight decay moves no frozen
weight either). The decoders still run in train mode as a whole, so the
BN statistics of the frozen stages update.

Adversarial: adds the Discriminator. It updates every `d_step` batches,
on (clean, reconstruction) before the generator's update, and the
generator then trains on 0.5 * (D(est) - 1)^2 + SI-SNR through the
updated D (the reference's order, train_second_phase_adversarial.py:
302-316). Model selection tracks the val SI-SNR (`recon_sisnr`), not the
total (line 393).

How one step keeps the JAX step's state updates:
  * The JAX step decodes twice on a D-update batch (once for D, once in
    the generator's loss) and keeps the second pass's decoder statistics.
    Both passes see the same weights, noise and batch, so this step
    decodes once, with autograd: D updates on the detached
    reconstruction, the generator's loss reuses it, and the decoders'
    running statistics move once per step.
  * The D update applies D to the clean and the estimated signal with
    the same incoming statistics and keeps the estimate pass's (its dis
    mode copies them in): the clean pass runs under `frozen_bn_stats`,
    so D's counter moves by one per update.
  * The generator's pass through D discards D's statistics (JAX's
    ``score, _ = ...``): it runs under `frozen_bn_stats`, with D's
    parameters not requiring grad through the generator's backward, so
    D's Adam sees only D's own loss.
  * `batch_counter` (the d_step phase) goes into meta.json and comes back
    on resume, so a resumed run interleaves D updates as an uninterrupted
    one does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.losses.phase2 import AdversarialPhase2Loss, TwoPhaseLoss
from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.models.discriminator import Discriminator
from idccrn_vae_torch.models.modules import frozen_bn_stats, set_bn_counts
from idccrn_vae_torch.models.nsvae import NsvaeEncoder, split_noisy_skips
from idccrn_vae_torch.models.vae import VaeDecoder
from idccrn_vae_torch.ops.stft import stft
from idccrn_vae_torch.train.loop import Trainer
from idccrn_vae_torch.train.optim import PlateauScheduler, make_adam
from idccrn_vae_torch.train.pretrain import tile_samples

DECODE_UPDATES = ("all_decode", "skip_layer")


def trained_parameters(decoder: VaeDecoder, decode_update: str):
    """The parameters of `decoder` that phase 2 trains: all of them, or
    for 'skip_layer' those of the stages `n - 1 - i` for i in
    skip_to_use (the reference's train_second_phase_decoder.py:145-150,
    the mirror of the stages that consume the skips)."""
    if decode_update == "all_decode":
        return list(decoder.parameters())
    n = len(decoder.decoders)
    return [p for i in decoder.cfg.skip_to_use
            for p in decoder.decoders[n - 1 - i].parameters()]


class Phase2Trainer(Trainer):
    """Classical decoder fine-tune; adversarial=True for LSGAN. Runs on
    the CUDA card unless `device` names another device. In a
    data-parallel group the decoders' trained parameters and D's are
    averaged over the ranks after their backwards, one flattened
    all-reduce per optimizer; D's batch statistics span the global
    batch, so the D step sees the generator's global outputs."""

    def __init__(self, enc_cfg: DccrnConfig, dec_cfg: DccrnConfig,
                 loss: TwoPhaseLoss, learning_rate: float,
                 adversarial: bool = False, dis_lr: float = 1e-4,
                 d_step: int = 1, decode_update: str = "all_decode",
                 weight_decay: float = 1e-3, seed: int = 123,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        enc_cfg.reject_int8_training("Phase2Trainer")
        dec_cfg.reject_int8_training("Phase2Trainer")
        if decode_update not in DECODE_UPDATES:
            raise ValueError(f"decode_update {decode_update!r} is not one "
                             f"of {DECODE_UPDATES}")
        self.enc_cfg = enc_cfg
        self.dec_cfg = dec_cfg
        self.loss = loss
        self.adversarial = adversarial
        self.adv_loss = AdversarialPhase2Loss(dec_cfg.latent_num)
        self.d_step = d_step
        self.decode_update = decode_update
        self.seed = seed
        self._batch_counter = 0
        gen = lambda k: torch.Generator().manual_seed(seed + k)
        self.encoder = NsvaeEncoder(enc_cfg, device=self.device,
                                    generator=gen(0))
        self.encoder.requires_grad_(False)
        self.decoder = VaeDecoder(dec_cfg, device=self.device,
                                  generator=gen(1))
        # the reference's adversarial script trains the clean decoder
        # only (train_second_phase_adversarial.py:300)
        self.noise_decoder = None
        if dec_cfg.latent_num == 2 and not adversarial:
            if enc_cfg.latent_num != 2:
                raise ValueError("a noise decoder (dec_cfg.latent_num 2) "
                                 "needs the encoder's noise latent "
                                 "(enc_cfg.latent_num 2)")
            self.noise_decoder = VaeDecoder(dec_cfg, device=self.device,
                                            generator=gen(2))
        params = []
        for dec in self.decoders.values():
            dec.requires_grad_(False)
            for p in trained_parameters(dec, decode_update):
                p.requires_grad_(True)
                params.append(p)
        self.opt = make_adam(params, learning_rate, weight_decay)
        self.sched = PlateauScheduler(0.5, 3)
        self.dis = self.opt_dis = self.sched_dis = None
        if adversarial:
            self.dis = Discriminator(dec_cfg, device=self.device,
                                     generator=gen(3))
            self.opt_dis = make_adam(self.dis.parameters(), dis_lr,
                                     weight_decay)
            self.sched_dis = PlateauScheduler(0.5, 3)

    @property
    def decoders(self) -> Dict[str, VaeDecoder]:
        out = {"decoder": self.decoder}
        if self.noise_decoder is not None:
            out["noise_decoder"] = self.noise_decoder
        return out

    @property
    def models(self):
        out = {"encoder": self.encoder, **self.decoders}
        if self.dis is not None:
            out["dis"] = self.dis
        return out

    @property
    def best_models(self):
        return tuple(self.models)

    @property
    def optimizers(self):
        out = {"opt": self.opt}
        if self.adversarial:
            out["opt_dis"] = self.opt_dis
        return out

    @property
    def schedulers(self):
        out = {"sched": (self.sched, "opt")}
        if self.adversarial:
            out["sched_dis"] = (self.sched_dis, "opt_dis")
        return out

    @property
    def loss_key(self) -> str:
        return "recon_sisnr" if self.adversarial else "total"

    def meta_fields(self) -> dict:
        return {"enc_config": dataclasses.asdict(self.enc_cfg),
                "dec_config": dataclasses.asdict(self.dec_cfg),
                "adversarial": self.adversarial,
                "decode_update": self.decode_update,
                "batch_counter": self._batch_counter}

    def resume_meta(self, meta: dict) -> None:
        self._batch_counter = int(meta.get("batch_counter", 0))

    def load_pretrained(self, pretrained: Dict[str, dict]) -> None:
        """Load state_dicts (name -> state_dict: 'encoder', the NSVAE
        run's noisy encoder; optionally 'decoder', a CVAE decoder) into
        the named models; their BN counters are set to 1, the loaded
        statistics being live (see `NsvaeTrainer.load_pretrained`)."""
        for name, sd in pretrained.items():
            self.models[name].load_state_dict(sd)
            set_bn_counts(self.models[name], 1)

    def _decode(self, batch, generator, train: bool, noise=None,
                noise_n=None):
        """Frozen encoder -> decoder(s) with real skips. Returns the clean
        decoder's (recon, predict), the tiled targets, and the noise
        decoder's outputs and targets (or {}). noise / noise_n: optional
        latent draws of the encoder (see `NsvaeEncoder.forward`)."""
        noisy, clean, noise_wav = self.batch_to_device(tuple(batch))
        with torch.no_grad():
            out = self.encoder(noisy, generator=generator, noise=noise,
                               noise_n=noise_n)
        ns = self.dec_cfg.num_samples
        s = self.enc_cfg.stft
        spec = lambda x: tile_samples(stft(x, s.n_fft, s.hop, s.win_length),
                                      ns)
        for dec in self.decoders.values():
            dec.train(train)
        recon_c, pred_c = self.decoder(
            out.stft_x, out.z_speech,
            split_noisy_skips(out.skips, self.enc_cfg, "speech"),
            pad_mode="sig")
        clean_t = tile_samples(clean, ns)[:, : recon_c.shape[1]]
        extras = {}
        if self.noise_decoder is not None:
            recon_n, pred_n = self.noise_decoder(
                out.stft_x, out.z_noise,
                split_noisy_skips(out.skips, self.enc_cfg, "noise"),
                pad_mode="sig")
            extras = {"predict_noise": pred_n, "stft_noise": spec(noise_wav),
                      "noise_wav": tile_samples(noise_wav, ns)[
                          :, : recon_n.shape[1]],
                      "recon_noise": recon_n}
        return recon_c, pred_c, clean_t, spec(clean), extras

    def _generator_loss(self, recon_c, pred_c, clean_t, clean_spec, extras,
                        train: bool):
        if self.adversarial:
            self.dis.train(train)
            with frozen_bn_stats(self.dis):
                score = self.dis(recon_c)
            total, l_recon, l_dis = self.adv_loss.generator_loss(
                clean_t, recon_c, score)
            return total, {"total": total, "recon_sisnr": l_recon,
                           "gen_dis": l_dis}
        lo = self.loss.phase_2_loss(pred_c, clean_spec, clean_t, recon_c,
                                    **extras)
        return lo.total, {"total": lo.total, "cpx_clean": lo.cpx_clean,
                          "mag_clean": lo.mag_clean,
                          "sisnr_clean": lo.sisnr_clean,
                          "recon_sisnr": lo.sisnr_clean}

    def _d_update(self, clean_t, est) -> torch.Tensor:
        """One discriminator update on (clean, est), both detached;
        returns the (pre-update) D loss."""
        self.dis.train()
        with frozen_bn_stats(self.dis):
            s_true = self.dis(clean_t)
        s_est = self.dis(est)
        d_loss = self.adv_loss.discriminator_loss(s_true, s_est)
        self.opt_dis.zero_grad(set_to_none=True)
        d_loss.backward()
        self.reduce_gradients(self.opt_dis)
        self.opt_dis.step()
        return d_loss.detach()

    def train_step(self, batch, generator: Optional[torch.Generator],
                   epoch: int, noise=None, noise_n=None):
        """One update on a (noisy, clean, noise) batch, each (B, L), and
        on D-update batches one discriminator update first; returns the
        metrics as 0-dim tensors on the device, and leaves the gradients
        of the decoders' (and D's) trained parameters in `.grad`.
        noise / noise_n inject the encoder's latent draws."""
        update_d = self.adversarial and (
            self._batch_counter % self.d_step == 0)
        self._batch_counter += 1
        recon_c, pred_c, clean_t, clean_spec, extras = self._decode(
            batch, generator, True, noise, noise_n)
        d_loss = (self._d_update(clean_t.detach(), recon_c.detach())
                  if update_d else None)
        # D's parameters need no gradient from the generator's loss; they
        # stay frozen through its backward, whose recompute (cfg.remat)
        # must save what the forward saved
        if self.adversarial:
            self.dis.requires_grad_(False)
        try:
            total, metrics = self._generator_loss(
                recon_c, pred_c, clean_t, clean_spec, extras, True)
            self.opt.zero_grad(set_to_none=True)
            total.backward()
        finally:
            if self.adversarial:
                self.dis.requires_grad_(True)
        self.reduce_gradients(self.opt)
        self.opt.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if d_loss is not None:
            metrics["dis"] = d_loss
        return metrics

    @torch.no_grad()
    def eval_step(self, batch, generator: Optional[torch.Generator],
                  epoch: int):
        """Validation metrics in eval mode, and for the adversarial run
        the D loss of eval-mode D on (clean, estimate)."""
        recon_c, pred_c, clean_t, clean_spec, extras = self._decode(
            batch, generator, False)
        _, metrics = self._generator_loss(recon_c, pred_c, clean_t,
                                          clean_spec, extras, False)
        if self.adversarial:
            metrics["dis"] = self.adv_loss.discriminator_loss(
                self.dis(clean_t), self.dis(recon_c))
        return metrics

    def fit(self, train_loader, val_loader, epochs: int, save_dir: str,
            early_stop_patience: int = 20, save_frequency: int = 10,
            model_name: str = "phase2_decoder", resume: bool = False,
            logger=None, pretrained: Optional[Dict[str, dict]] = None):
        """pretrained: optional name -> state_dict, loaded before training
        (and overridden by the state of a resume)."""
        self._batch_counter = 0
        if pretrained:
            self.load_pretrained(pretrained)
        return super().fit(train_loader, val_loader, epochs, save_dir,
                           early_stop_patience, save_frequency, model_name,
                           resume, logger)
