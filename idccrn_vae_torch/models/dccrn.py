"""Supervised DCCRN enhancement model (the reference baseline).

Mirrors `idccrn_vae_tpu/models/dccrn.py`: STFT -> (datanorm) -> conv
encoder -> complex LSTM -> complex dense -> transposed-conv decoder with
skips -> mask | real_imag reconstruction -> ISTFT.

The layers sit in one inner module whose name is the reference's
attribute (`std_DCCRN` for pvae_module's DCCRN_, `DCCRN` for the legacy
module.DCCRN_), so the state_dict names are the reference's
(``std_DCCRN.encoders.0.conv.conv_re.weight``, ...) and the JAX
package's `torch_import.import_supervised_dccrn` /
`import_legacy_dccrn` read them back. The reference's 1x1 ``linear``
conv is never applied; its keys in a reference checkpoint are dropped
on load, as the JAX importer drops them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    unflatten_bottleneck,
)
from idccrn_vae_torch.models.vae import (
    datanorm_of,
    finish_reconstruction,
    register_datanorm,
)
from idccrn_vae_torch.ops.stft import stft


class DccrnLayers(nn.Module):
    """encoders, lstms.0, dense and decoders of one supervised DCCRN."""

    def __init__(self, cfg: DccrnConfig, gen: torch.Generator):
        super().__init__()
        c, f = bottleneck_dims(cfg)
        self.encoders = build_encoder_stages(cfg, gen)
        self.lstms = nn.ModuleList(
            [ComplexLSTM(c * f, cfg.lstm_hidden, cfg.lstm_layers, gen)])
        self.dense = ComplexDense(cfg.lstm_hidden, c * f, gen)
        self.decoders = build_decoder_stages(cfg, gen)


class SupervisedDccrn(nn.Module):
    """Supervised DCCRN.

    Built in eval mode; `.train()` switches the encoder's and the
    decoder's BN to batch statistics with their running update
    (training, `train/supervised.py`), as the JAX model's
    ``apply(train=True)``. Weights are drawn on the CPU from `generator`
    and moved to `device` (CUDA unless the caller asks for another
    device).
    """

    prefix = "std_DCCRN"

    def __init__(self, cfg: DccrnConfig,
                 datanorm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.add_module(self.prefix,
                        DccrnLayers(cfg, default_generator(generator)))
        register_datanorm(self, datanorm)
        self.eval()
        self.to(device)

    @property
    def layers(self) -> DccrnLayers:
        return getattr(self, self.prefix)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        dead = f"{self.prefix}.linear."
        kept = {k: v for k, v in state_dict.items() if not k.startswith(dead)}
        return super().load_state_dict(kept, strict=strict, assign=assign)

    def forward(self, wav: torch.Tensor, return_latent: bool = False):
        """wav (B, L) -> (clean (B, L'), predict_spec (B, F, T, 2)).

        return_latent additionally returns the LSTM bottleneck features
        (B, T, 2H), the reference's eval-time `self.latent`.
        """
        cfg, net = self.cfg, self.layers
        c, f = bottleneck_dims(cfg)
        datanorm = datanorm_of(self)
        lstm_out, skips, stft_x = apply_backbone(
            net.encoders, net.lstms[0], wav, cfg, datanorm)
        dense_out = net.dense(
            lstm_out, compute_dtype=None if cfg.compute == "f32"
            else cfg.compute_dtype)
        out = apply_decoder_stack(net.decoders,
                                  unflatten_bottleneck(dense_out, c, f),
                                  skips, cfg, num_samples=1)
        recon_sig, predict = finish_reconstruction(out, stft_x, cfg, 1,
                                                   datanorm)
        if return_latent:
            return recon_sig, predict, lstm_out
        return recon_sig, predict

    def stft_clean(self, wav: torch.Tensor) -> torch.Tensor:
        """Raw target spectrogram (no datanorm): the reference computes
        the supervised target with the bare STFT while the prediction is
        de-normalized."""
        s = self.cfg.stft
        return stft(wav, s.n_fft, s.hop, s.win_length)


class LegacyDccrn(SupervisedDccrn):
    """The reference's legacy polar-mask DCCRN (module.DCCRN_): the
    supervised DCCRN pinned to non-causal blocks, a real skip at every
    decoder stage, the tanh-polar mask and no datanorm; its forward
    returns the waveform only."""

    prefix = "DCCRN"

    def __init__(self, cfg: DccrnConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        cfg = dataclasses.replace(
            cfg, causal=False, recon_type="mask", skip_mode="real",
            skip_to_use=tuple(range(cfg.num_stages)))
        super().__init__(cfg, datanorm=None, device=device,
                         generator=generator)

    def forward(self, wav: torch.Tensor  # type: ignore[override]
                ) -> torch.Tensor:
        """wav (B, L) -> clean (B, L')."""
        return super().forward(wav)[0]
