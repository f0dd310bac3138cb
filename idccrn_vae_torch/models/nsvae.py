"""NSVAE noisy encoder — emits one or two complex-Gaussian latents.

Mirrors `idccrn_vae_tpu/models/nsvae.py`: channel_mode / latent /
latent_num are DccrnConfig flags. NSVAE encoders never apply datanorm.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.models.backbone import apply_backbone
from idccrn_vae_torch.models.config import DccrnConfig, bottleneck_dims
from idccrn_vae_torch.models.modules import (
    ComplexDense,
    ComplexLSTM,
    build_encoder_stages,
    default_generator,
)
from idccrn_vae_torch.models.reparam import CGauss, reparameterize
from idccrn_vae_torch.models.vae import HEADS, apply_fc_head, parse_sliced_head
from idccrn_vae_torch.utils.profiling import span


class NsvaeOut(NamedTuple):
    z_speech: torch.Tensor
    gauss_speech: CGauss
    z_noise: Optional[torch.Tensor]
    gauss_noise: Optional[CGauss]
    skips: list
    stft_x: torch.Tensor


class NsvaeEncoder(nn.Module):
    """NSVAE noisy encoder.

    Built in eval mode; `.train()` switches BN to batch statistics
    (training). Weights are drawn on the CPU from `generator` and moved
    to `device` (CUDA unless the caller asks for another device).
    """

    def __init__(self, cfg: DccrnConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = default_generator(generator)
        self.cfg = cfg
        self.guard = "clamp" if cfg.latent == "fc" else "eps"
        self.encoders = build_encoder_stages(cfg, gen)
        c, f = bottleneck_dims(cfg)
        lstm_out = (cfg.zdim if cfg.latent == "fc"
                    else 3 * cfg.zdim * cfg.latent_num)
        self.lstms = nn.ModuleList(
            [ComplexLSTM(c * f, lstm_out, cfg.lstm_layers, gen)])
        if cfg.latent == "fc":
            groups = ("speech", "noise")[: cfg.latent_num]
            for group in groups:
                for head in HEADS:
                    self.add_module(f"{group}_dense_{head}",
                                    ComplexDense(cfg.zdim, cfg.zdim, gen))
        self.eval()
        self.to(device)

    def _fc_heads(self, group: str):
        return {h: getattr(self, f"{group}_dense_{h}") for h in HEADS}

    def forward(self, wav: torch.Tensor, num_samples: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                noise_n: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> NsvaeOut:
        """wav (B, L) -> NsvaeOut.

        noise / noise_n: optional (eps_r, eps_i) for the speech / the
        noise latent, each (B, S, T, zdim); a latent without one draws
        from `generator`.
        """
        cfg = self.cfg
        ns = cfg.num_samples if num_samples is None else num_samples
        lstm_out, skips, stft_x = apply_backbone(
            self.encoders, self.lstms[0], wav, cfg)
        with span("idccrn.latent"):
            if cfg.latent == "fc":
                g_s = apply_fc_head(lstm_out, self._fc_heads("speech"))
                g_n = (apply_fc_head(lstm_out, self._fc_heads("noise"))
                       if cfg.latent_num == 2 else None)
            else:
                g_s = parse_sliced_head(lstm_out, cfg.zdim, offset=0)
                g_n = (parse_sliced_head(lstm_out, cfg.zdim, offset=3)
                       if cfg.latent_num == 2 else None)
            z_s = reparameterize(g_s, ns, guard=self.guard, noise=noise,
                                 generator=generator)
            z_n = (reparameterize(g_n, ns, guard=self.guard, noise=noise_n,
                                  generator=generator)
                   if g_n is not None else None)
        return NsvaeOut(z_s, g_s, z_n, g_n, skips, stft_x)


def split_noisy_skips(skips, cfg: DccrnConfig, which: str = "speech"):
    """Half-split the double/adapt noisy encoder's skip channels.

    The first half of each doubled stage's channels is speech, the
    second noise; for 'adapt' only the doubled stages split. Returns
    skips at the pretrain-geometry channel counts the decoder expects.
    """
    if cfg.channel_mode == "normal":
        return list(skips)
    out = []
    n = cfg.num_stages
    for i, s in enumerate(skips):
        doubled = cfg.channel_mode == "double" or (
            cfg.channel_mode == "adapt" and (n - 1 - i) in cfg.skip_to_use)
        if not doubled:
            out.append(s)
            continue
        c = s.shape[-1] // 2  # complex channels (already doubled)
        half = c // 2
        re, im = s[..., :c], s[..., c:]
        if which == "speech":
            out.append(torch.cat([re[..., :half], im[..., :half]], dim=-1))
        else:
            out.append(torch.cat([re[..., half:], im[..., half:]], dim=-1))
    return out
