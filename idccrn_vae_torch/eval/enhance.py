"""Batched enhancement runner — the serving path.

Mirrors `idccrn_vae_tpu/eval/enhance.py` for the speech latent
(``latent_to_use=1``, ``outtype="clean_direct"``): STFT -> NSVAE noisy
encoder -> latent sampling -> decoder -> ISTFT -> mean over samples.
Utterances are sorted by length and padded up to bucket lengths
(multiples of `bucket_frames` STFT frames), the convention the JAX
package's eval runners share.

Not ported yet (ROADMAP queue 1 item 10): the dual-latent path
(``latent_to_use=2``), the mask out-types and `encode_latents`.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.models.nsvae import NsvaeEncoder, split_noisy_skips
from idccrn_vae_torch.models.vae import VaeDecoder

DEFAULT_BUCKET_FRAMES = 100

_DUAL_TODO = ("is not ported to idccrn_vae_torch yet (ROADMAP queue 1 "
              "item 10: dual-latent serving)")


def bucket_pad_length(n_samples: int, hop: int,
                      bucket_frames: int = DEFAULT_BUCKET_FRAMES) -> int:
    """Smallest bucket (in samples) holding an n_samples utterance:
    frame count (n//hop + 1) rounded up to a multiple of bucket_frames."""
    frames = n_samples // hop + 1
    frames_b = ((frames + bucket_frames - 1) // bucket_frames) * bucket_frames
    return frames_b * hop


def _sample_mean(x: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B*S, ...) -> (B, ...) mean over the sample dim."""
    return x.reshape((-1, num_samples) + tuple(x.shape[1:])).mean(dim=1)


class Enhancer:
    """NSVAE encoder + pretrained/fine-tuned decoder speech enhancer.

    enc_state / dec_state are state_dicts under the reference's names
    (a port module's `state_dict()`, or a reference checkpoint). The
    models run on `device`: CUDA unless the caller asks for another.

    sample_chunks: decode num_samples in this many sequential chunks
    instead of one B*S batch — same outputs, peak decoder memory divided
    by sample_chunks.
    """

    def __init__(self, enc_cfg: DccrnConfig, dec_cfg: DccrnConfig,
                 enc_state: Mapping[str, torch.Tensor],
                 dec_state: Mapping[str, torch.Tensor],
                 num_samples: int = 10, outtype: str = "clean_direct",
                 latent_to_use: int = 1, pad_mode: str = "sig",
                 bucket_frames: int = DEFAULT_BUCKET_FRAMES,
                 sample_chunks: int = 1, device: DeviceLike = None):
        if latent_to_use not in (1, 2):
            raise ValueError(f"latent_to_use must be 1 or 2, got "
                             f"{latent_to_use}")
        if latent_to_use == 2:
            raise NotImplementedError(f"latent_to_use=2 {_DUAL_TODO}")
        if outtype != "clean_direct":
            raise NotImplementedError(f"outtype={outtype!r} {_DUAL_TODO}")
        if sample_chunks < 1 or num_samples % sample_chunks:
            raise ValueError(f"sample_chunks={sample_chunks} must divide "
                             f"num_samples={num_samples}")
        self.device = resolve_device(device)
        self.enc_cfg = enc_cfg
        self.dec_cfg = dec_cfg
        self.encoder = NsvaeEncoder(enc_cfg, device=self.device)
        self.encoder.load_state_dict(enc_state)
        self.decoder = VaeDecoder(dec_cfg, device=self.device)
        self.decoder.load_state_dict(dec_state)
        self.num_samples = num_samples
        self.pad_mode = pad_mode
        self.bucket_frames = bucket_frames
        self.sample_chunks = sample_chunks

    def new_generator(self, seed: int = 0) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.inference_mode()
    def forward(self, wav: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """The enhancement program: (B, L) -> (B, (T - 1) * hop).

        noise: optional (eps_r, eps_i) for the latent draws, each
        (B, num_samples, T, zdim); otherwise they come from `generator`.
        """
        ns, chunks = self.num_samples, self.sample_chunks
        out = self.encoder(wav, num_samples=ns, generator=generator,
                           noise=noise)
        skips = split_noisy_skips(out.skips, self.enc_cfg, "speech")
        if chunks == 1:
            recon, _ = self.decoder(out.stft_x, out.z_speech, skips,
                                    num_samples=ns, pad_mode=self.pad_mode)
            return _sample_mean(recon, ns)
        # rows are batch-major, sample-minor: (B*S, ...) -> (B, S, ...);
        # equal chunk sizes, so the mean of chunk means is the full mean
        sc = ns // chunks
        z = out.z_speech
        zb = z.reshape((wav.shape[0], ns) + tuple(z.shape[1:]))
        parts = []
        for c in range(chunks):
            zc = zb[:, c * sc : (c + 1) * sc].reshape((-1,) + tuple(z.shape[1:]))
            recon, _ = self.decoder(out.stft_x, zc, skips, num_samples=sc,
                                    pad_mode=self.pad_mode)
            parts.append(_sample_mean(recon, sc))
        return torch.stack(parts).mean(dim=0)

    def bucket_length(self, n_samples: int) -> int:
        return bucket_pad_length(n_samples, self.enc_cfg.stft.hop,
                                 self.bucket_frames)

    # -- public API --------------------------------------------------------
    def enhance_batch(self, wavs, generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Enhance a padded batch (B, L) (numpy or tensor); L should be a
        bucket length. Returns a tensor on the Enhancer's device, so a
        caller can chain batches without host copies."""
        generator = self.new_generator() if generator is None else generator
        wav = torch.as_tensor(wavs, dtype=torch.float32, device=self.device)
        return self.forward(wav, generator)

    def encode_latents(self, wavs, batch_size: int = 8, generator=None):
        raise NotImplementedError(f"encode_latents {_DUAL_TODO}")

    def enhance_utterances(self, wavs: Sequence[np.ndarray],
                           batch_size: int = 8,
                           generator: Optional[torch.Generator] = None
                           ) -> List[np.ndarray]:
        """Length-bucketed padded batched enhancement of a wav list.

        One generator advances through the batches; each output is
        trimmed to its input's length.
        """
        generator = self.new_generator() if generator is None else generator
        order = np.argsort([len(w) for w in wavs])
        results: List[Optional[np.ndarray]] = [None] * len(wavs)
        for i in range(0, len(order), batch_size):
            chunk = order[i : i + batch_size]
            bucket = self.bucket_length(max(len(wavs[j]) for j in chunk))
            batch = np.zeros((len(chunk), bucket), np.float32)
            for r, j in enumerate(chunk):
                batch[r, : len(wavs[j])] = wavs[j]
            out = self.enhance_batch(batch, generator).cpu().numpy()
            for r, j in enumerate(chunk):
                results[j] = out[r, : min(len(wavs[j]), out.shape[1])]
        return results  # type: ignore[return-value]
