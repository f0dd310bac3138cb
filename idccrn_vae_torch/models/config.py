"""Frozen model configuration, mirrored from the JAX package.

The port keeps its own copy of the config (it imports nothing of
`idccrn_vae_tpu`). The fields, defaults and plan arithmetic are the
same as `idccrn_vae_tpu/models/config.py`; the channel plans are pure
arithmetic and the tests hold them equal to the JAX plans for every
`channel_mode` x `skip_mode`.

The reference geometry: channels 1-32-64-128-128-256-256, kernels
(5, 2), strides (2, 1), freq pad 2, time pad 1 causal / 0 non-causal.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StftConfig:
    n_fft: int = 512
    hop: int = 100
    win_length: int = 400
    fs: int = 16000

    @property
    def freq_bins(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class DccrnConfig:
    stft: StftConfig = StftConfig()
    encoder_channels: Tuple[int, ...] = (1, 32, 64, 128, 128, 256, 256)
    kernel: Tuple[int, int] = (5, 2)
    stride: Tuple[int, int] = (2, 1)
    freq_pad: int = 2
    causal: bool = True
    lstm_layers: int = 2
    lstm_hidden: int = 128
    zdim: int = 128
    num_samples: int = 5
    # decoder stages receiving skip connections (reference skip_to_use)
    skip_to_use: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    # 'sliced': LSTM emits 3*zdim (or 6*zdim) complex, sliced into
    #   (mu, log_sigma, delta); 'fc': LSTM emits zdim, ComplexDense heads.
    latent: Literal["sliced", "fc"] = "sliced"
    latent_num: int = 1
    # 'normal' | 'double' (all channels x2, skips split speech/noise) |
    # 'adapt' (x2 only at stages feeding skip_to_use) — NSVAE encoders.
    channel_mode: Literal["normal", "double", "adapt"] = "normal"
    # decoder skip handling: 'real' | 'none' | 'zero' | 'prob' | 'runtime'
    # (see the JAX config for the reference classes each one replaces).
    skip_mode: Literal["real", "none", "zero", "prob", "runtime"] = "real"
    skip_prob: int = 1
    recon_type: Literal["mask", "real_imag"] = "real_imag"
    resynthesis: bool = False
    # 'f32' | 'bf16' | 'int8': dtype of the conv/LSTM/dense operands.
    # Parameters, BN statistics, STFT/ISTFT and the latent head stay
    # float32. 'int8' is a serving-only mode (the trainers refuse it):
    # the convs whose channel counts both reach quant_min_ch run on int8
    # operands with int32 accumulation (`ops/conv.quantized_conv`), the
    # encoder's always and the decoder's with quant_scope 'all';
    # everything else runs as 'bf16'.
    compute: Literal["f32", "bf16", "int8"] = "f32"
    # int8: narrower stages keep bf16 (the first encoder conv sees the
    # raw spectrum, whose range one int8 scale per sample cannot cover)
    quant_min_ch: int = 16
    quant_scope: Literal["enc", "all"] = "enc"
    remat: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        """Operand dtype of the LSTM, the dense layer and the convs int8
        mode leaves unquantized: int8 mode rides bf16, as in the JAX
        package."""
        return (torch.bfloat16 if self.compute in ("bf16", "int8")
                else torch.float32)

    @property
    def conv_quant(self) -> bool:
        return self.compute == "int8"

    def reject_int8_training(self, who: str) -> None:
        """Trainers call this: int8 is serving-only (the rounding has no
        useful gradient, and a train-mode forward would run bf16 while
        validation quantized). The JAX package's error and message."""
        if self.compute == "int8":
            raise ValueError(
                f"{who}: compute='int8' is a serving-only mode — train "
                "with 'bf16' (or 'f32') and pass --compute int8 at "
                "evaluation/serving time instead.")

    @property
    def num_stages(self) -> int:
        return len(self.encoder_channels) - 1

    @property
    def decoder_channels(self) -> Tuple[int, ...]:
        return tuple(reversed(self.encoder_channels[1:])) + (1,)


def encoder_plan(cfg: DccrnConfig) -> Tuple[Tuple[int, int], ...]:
    """Per-stage (in_ch, out_ch) for the encoder, honoring channel_mode.

    double: every conv channel count x2 except the 1-channel input.
    adapt: stage i doubled iff decoder index (num_stages-1-i) is in
    skip_to_use.
    """
    ch = list(cfg.encoder_channels)
    n = cfg.num_stages
    if cfg.channel_mode == "double":
        ch = [ch[0]] + [2 * c for c in ch[1:]]
    elif cfg.channel_mode == "adapt":
        for i in range(1, n + 1):
            # stage (i-1) output feeds decoder index n - i
            if (n - i) in cfg.skip_to_use:
                ch[i] = 2 * ch[i]
    return tuple((ch[i], ch[i + 1]) for i in range(n))


def decoder_plan(cfg: DccrnConfig) -> Tuple[Tuple[int, int], ...]:
    """Per-stage (in_ch, out_ch) for the decoder including skip concat.

    The skip at stage i adds the pretrain-geometry encoder channel count
    encoder_channels[n - i]: the NSVAE double/adapt widths only affect
    the noisy encoder, whose skips are split back to nominal width.
    """
    de = cfg.decoder_channels
    en = cfg.encoder_channels
    n = cfg.num_stages
    plan = []
    for i in range(n):
        in_ch = de[i]
        if cfg.skip_mode != "none" and i in cfg.skip_to_use:
            in_ch += en[n - i]
        plan.append((in_ch, de[i + 1]))
    return tuple(plan)


def freq_sizes(cfg: DccrnConfig) -> Tuple[int, ...]:
    """Frequency-bin count after each encoder stage (257→129→…→5)."""
    f = cfg.stft.freq_bins
    sizes = []
    for _ in range(cfg.num_stages):
        f = (f + 2 * cfg.freq_pad - cfg.kernel[0]) // cfg.stride[0] + 1
        sizes.append(f)
    return tuple(sizes)


def bottleneck_dims(cfg: DccrnConfig) -> Tuple[int, int]:
    """(C, F) at the bottleneck; C*F is the LSTM input width (1280)."""
    plan = encoder_plan(cfg)
    return plan[-1][1], freq_sizes(cfg)[-1]
