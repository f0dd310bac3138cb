"""LSGAN discriminator of phase-2 adversarial fine-tuning.

Mirrors `idccrn_vae_tpu/models/discriminator.py` (the reference's
distinguisher, pvae_module.py:2271-2351): STFT -> the conv encoder stack
with dis-mode complex BN (every train batch's statistics are copied in)
-> the bottleneck flattened C-major, re/im interleaved per (c, f) ->
a real 2-layer LSTM of hidden size 1 -> a per-frame score (B, T, 1).

The state_dict names are the reference's (``encoders.{i}.*``,
``lstms.0.weight_ih_l{k}``), so the JAX package's
`torch_import.import_discriminator` reads them back.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.models.config import DccrnConfig, bottleneck_dims
from idccrn_vae_torch.models.modules import (
    LstmWeights,
    apply_encoder_stack,
    build_encoder_stages,
    default_generator,
    flatten_bottleneck,
)
from idccrn_vae_torch.ops.lstm import lstm
from idccrn_vae_torch.ops.stft import stft


class Discriminator(nn.Module):
    """Built in eval mode; `.train()` switches BN to batch statistics.
    Weights are drawn on the CPU from `generator` and moved to `device`
    (CUDA unless the caller asks for another device)."""

    def __init__(self, cfg: DccrnConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = default_generator(generator)
        self.cfg = cfg
        c, f = bottleneck_dims(cfg)
        self.encoders = build_encoder_stages(cfg, gen, dis_mode=True)
        self.lstms = nn.ModuleList(
            [LstmWeights(2 * c * f, 1, cfg.lstm_layers, gen)])
        self.eval()
        self.to(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """wav (B, L) -> score (B, T, 1) float32."""
        s = self.cfg.stft
        x, _ = apply_encoder_stack(
            self.encoders, stft(wav, s.n_fft, s.hop, s.win_length), self.cfg)
        b, _, t, _ = x.shape
        re, im = flatten_bottleneck(x).chunk(2, dim=-1)
        seq = torch.stack([re, im], dim=-1).reshape(b, t, -1)
        return lstm(seq, self.lstms[0].layers())
