"""Shared encode backbone: STFT -> (datanorm) -> conv stack -> complex LSTM.

Mirrors `idccrn_vae_tpu/models/backbone.py` in cpack layout.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.models.modules import (
    ComplexLSTM,
    EncoderStage,
    apply_datanorm,
    apply_encoder_stack,
    flatten_bottleneck,
)
from idccrn_vae_torch.ops.stft import stft
from idccrn_vae_torch.utils.profiling import span


def apply_backbone(stages: Sequence[EncoderStage], lstm: ComplexLSTM,
                   wav: torch.Tensor, cfg: DccrnConfig,
                   datanorm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """wav (B, L) -> (lstm_out (B, T, 2H) float32, skips, stft_x (B, F, T, 2)).

    stft_x is post-datanorm when datanorm=(mean, std) is given.
    """
    s = cfg.stft
    with span("idccrn.stft"):
        stft_x = stft(wav, s.n_fft, s.hop, s.win_length)
        if datanorm is not None:
            stft_x = apply_datanorm(stft_x, datanorm[0], datanorm[1])
    with span("idccrn.enc"):
        x, skips = apply_encoder_stack(stages, stft_x, cfg)
    seq = flatten_bottleneck(x)  # (B, T, 2*C*F)
    cdt = None if cfg.compute == "f32" else cfg.compute_dtype
    return lstm(seq, compute_dtype=cdt), skips, stft_x
