"""VAE encoder/decoder pair (CVAE / NVAE pretraining models) and the
latent heads shared with the NSVAE encoder.

Mirrors `idccrn_vae_tpu/models/vae.py`: `EncoderOut`, `VaeEncoder`,
`parse_sliced_head`, `apply_fc_head`, `VaeDecoder` and
`finish_reconstruction`. The decoder returns ``(recon_sig,
predict_spec)`` like the reference's pvae_dccrn_decoder.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.models.backbone import apply_backbone
from idccrn_vae_torch.models.config import DccrnConfig, bottleneck_dims
from idccrn_vae_torch.models.modules import (
    ComplexDense,
    ComplexLSTM,
    apply_decoder_stack,
    build_decoder_stages,
    build_encoder_stages,
    default_generator,
    mask_reconstruct,
    undo_datanorm,
    unflatten_bottleneck,
)
from idccrn_vae_torch.models.reparam import CGauss, reparameterize
from idccrn_vae_torch.ops.stft import istft, stft
from idccrn_vae_torch.utils.profiling import span

HEADS = ("mean", "logvar", "delta")


class EncoderOut(NamedTuple):
    z: torch.Tensor          # (B*S, T, 2*zdim) cpack
    gauss: CGauss            # posterior parameters, each (B, T, zdim)
    skips: list              # encoder skips (cpack maps)
    stft_x: torch.Tensor     # (B, F, T, 2), post-datanorm if enabled


def register_datanorm(module: nn.Module, datanorm) -> None:
    """Per-bin (F, 2) mean/std as non-persistent buffers `dn_mean` /
    `dn_std` (None without datanorm): not in the reference's state_dict."""
    mean, std = (None, None) if datanorm is None else (
        torch.as_tensor(d, dtype=torch.float32) for d in datanorm)
    module.register_buffer("dn_mean", mean, persistent=False)
    module.register_buffer("dn_std", std, persistent=False)


def datanorm_of(module: nn.Module):
    return None if module.dn_mean is None else (module.dn_mean, module.dn_std)


def parse_sliced_head(lstm_out: torch.Tensor, zdim: int,
                      offset: int = 0) -> CGauss:
    """Slice (mu, log_sigma, delta) from a 3*zdim (or 6*zdim) cpack
    sequence; offset in zdim units selects the speech (0) or noise (3)
    triplet of a dual-latent head."""
    h = lstm_out.shape[-1] // 2
    re, im = lstm_out[..., :h], lstm_out[..., h:]
    o = offset * zdim
    return CGauss(
        mu_r=re[..., o : o + zdim],
        mu_i=im[..., o : o + zdim],
        log_sigma=re[..., o + zdim : o + 2 * zdim],
        log_sigma_i=im[..., o + zdim : o + 2 * zdim],
        delta_r=re[..., o + 2 * zdim : o + 3 * zdim],
        delta_i=im[..., o + 2 * zdim : o + 3 * zdim],
    )


def apply_fc_head(lstm_out: torch.Tensor,
                  heads: Dict[str, ComplexDense]) -> CGauss:
    """Three ComplexDense heads (mean, logvar, delta) of the fc-latent
    family."""
    mu = heads["mean"](lstm_out)
    ls = heads["logvar"](lstm_out)
    dl = heads["delta"](lstm_out)
    z = mu.shape[-1] // 2
    return CGauss(
        mu_r=mu[..., :z], mu_i=mu[..., z:],
        log_sigma=ls[..., :z], log_sigma_i=ls[..., z:],
        delta_r=dl[..., :z], delta_i=dl[..., z:],
    )


class VaeEncoder(nn.Module):
    """Pretrain VAE encoder (CVAE on clean speech / NVAE on noise): the
    sliced 3*zdim LSTM head, or for ``latent="fc"`` the `dense_mean` /
    `dense_logvar` / `dense_delta` heads, the reference's names. Optional
    per-bin datanorm before the conv stack.

    Built in eval mode; `.train()` switches BN to batch statistics
    (training). Weights are drawn on the CPU from `generator` and moved
    to `device` (CUDA unless the caller asks for another device).
    """

    def __init__(self, cfg: DccrnConfig,
                 datanorm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = default_generator(generator)
        self.cfg = cfg
        self.guard = "clamp" if cfg.latent == "fc" else "eps"
        self.encoders = build_encoder_stages(cfg, gen)
        c, f = bottleneck_dims(cfg)
        lstm_out = cfg.zdim if cfg.latent == "fc" else 3 * cfg.zdim
        self.lstms = nn.ModuleList(
            [ComplexLSTM(c * f, lstm_out, cfg.lstm_layers, gen)])
        if cfg.latent == "fc":
            for head in HEADS:
                self.add_module(f"dense_{head}",
                                ComplexDense(cfg.zdim, cfg.zdim, gen))
        register_datanorm(self, datanorm)
        self.eval()
        self.to(device)

    def forward(self, wav: torch.Tensor, num_samples: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> EncoderOut:
        """wav (B, L) -> EncoderOut.

        noise: optional (eps_r, eps_i), each (B, S, T, zdim); otherwise
        the draws come from `generator`.
        """
        cfg = self.cfg
        ns = cfg.num_samples if num_samples is None else num_samples
        lstm_out, skips, stft_x = apply_backbone(
            self.encoders, self.lstms[0], wav, cfg, datanorm_of(self))
        with span("idccrn.latent"):
            if cfg.latent == "fc":
                gauss = apply_fc_head(
                    lstm_out, {h: getattr(self, f"dense_{h}") for h in HEADS})
            else:
                gauss = parse_sliced_head(lstm_out, cfg.zdim)
            z = reparameterize(gauss, ns, guard=self.guard, noise=noise,
                               generator=generator)
        return EncoderOut(z, gauss, skips, stft_x)


class VaeDecoder(nn.Module):
    """Pretrain VAE decoder; skip handling per cfg.skip_mode.

    Built in eval mode; `.train()` switches BN to batch statistics and
    skip_mode 'prob' to its per-forward coin. Weights are drawn on the
    CPU from `generator` and moved to `device` (CUDA unless the caller
    asks for another device).
    """

    def __init__(self, cfg: DccrnConfig,
                 datanorm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = default_generator(generator)
        self.cfg = cfg
        c, f = bottleneck_dims(cfg)
        self.dense = ComplexDense(cfg.zdim, c * f, gen)
        self.decoders = build_decoder_stages(cfg, gen)
        register_datanorm(self, datanorm)
        self.eval()
        self.to(device)

    def forward(self, stft_x: torch.Tensor, z: torch.Tensor, skips,
                num_samples: Optional[int] = None, pad_mode: str = "sig",
                generator: Optional[torch.Generator] = None,
                skip_coin=None):
        """Returns (recon_sig (B*S, L), predict_spec (B*S, F, T, 2)).

        dense -> unflatten -> transposed-conv stack (skips shared over
        the samples) -> recon_type branch -> ISTFT.

        skip_mode 'prob' in train mode tosses one coin per forward
        (real skips or the skip_prob alternative, see
        `apply_decoder_stack`): `skip_coin` (a bool or a 0-dim bool
        tensor) injects it; otherwise it is drawn from `generator`, on
        z's device, with probability 0.5.
        """
        cfg = self.cfg
        ns = cfg.num_samples if num_samples is None else num_samples
        c, f = bottleneck_dims(cfg)
        if cfg.skip_mode == "prob" and self.training:
            if skip_coin is None:
                skip_coin = torch.rand((), generator=generator,
                                       device=z.device) < 0.5
            skip_coin = torch.as_tensor(skip_coin, device=z.device)
        else:
            skip_coin = None
        with span("idccrn.dec"):
            dense_out = self.dense(
                z, compute_dtype=None if cfg.compute == "f32"
                else cfg.compute_dtype)  # (B*S, T, 2*C*F) float32
            p = unflatten_bottleneck(dense_out, c, f)
            out = apply_decoder_stack(self.decoders, p, skips, cfg,
                                      num_samples=ns, pad_mode=pad_mode,
                                      skip_coin=skip_coin)
        return finish_reconstruction(out, stft_x, cfg, ns, datanorm_of(self))


def finish_reconstruction(out: torch.Tensor, stft_x: torch.Tensor,
                          cfg: DccrnConfig, num_samples: int, datanorm):
    """recon_type branch + datanorm undo + ISTFT (+ resynthesis).

    out: decoder output (B*S, F, T, 2); stft_x: (B, F, T, 2).
    """
    s = cfg.stft
    with span("idccrn.istft"):
        out = out.float()  # leave reduced precision at the edge
        if cfg.recon_type == "mask":
            tiled = stft_x.repeat_interleave(num_samples, dim=0)
            predict = mask_reconstruct(out, tiled)
        else:  # 'real_imag'
            predict = out
        if datanorm is not None:
            predict = undo_datanorm(predict, datanorm[0], datanorm[1])
        recon_sig = istft(predict, s.n_fft, s.hop, s.win_length)
        if cfg.resynthesis:
            predict = stft(recon_sig, s.n_fft, s.hop, s.win_length)
    return recon_sig, predict
