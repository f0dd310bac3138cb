"""Batched enhancement runner — the serving path.

Mirrors `idccrn_vae_tpu/eval/enhance.py`: STFT -> NSVAE noisy encoder
-> latent sampling -> decoder(s) -> (out-type combination) -> ISTFT,
with the mean over samples. Utterances are sorted by length and padded
up to bucket lengths (multiples of `bucket_frames` STFT frames), the
convention the JAX package's eval runners share.

The bucketing entry (`BucketedEnhancer`: `_bucketed`, `enhance_batch`,
`enhance_utterances`, the counters and spans) is shared with CMGAN's
generator (`CmganEnhancer`, `models/cmgan.py`), which pads and runs a
batch its own way and takes each row's length.

Out-types (latent_to_use=2 for all but the first):
  'clean_direct'    — sample-mean of the speech decoder's waveform
  'real_imag_mask'  — Wiener-style per-component ratio masks
  'complex_mask'    — complex ratio S/(S+N)
  'phase_mask'      — phase-sensitive mask |S|/(|S|+|N|)*cos(dphi)
                      applied to |Y| with the speech phase
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.models.cmgan import TSCNet
from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.models.nsvae import NsvaeEncoder, split_noisy_skips
from idccrn_vae_torch.models.vae import VaeDecoder
from idccrn_vae_torch.ops.stft import istft, stft
from idccrn_vae_torch.parallel import distributed
from idccrn_vae_torch.parallel.mesh import padded_rows, shard_batch
from idccrn_vae_torch.utils.profiling import span

DEFAULT_BUCKET_FRAMES = 100
OUTTYPES = ("clean_direct", "real_imag_mask", "complex_mask", "phase_mask")

Eps = Optional[Tuple[torch.Tensor, torch.Tensor]]


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


def _complex(spec: torch.Tensor) -> torch.Tensor:
    return torch.complex(spec[..., 0], spec[..., 1])


def _real_imag(c: torch.Tensor) -> torch.Tensor:
    return torch.stack([c.real, c.imag], dim=-1)


def combine_outputs(outtype: str, speech_spec: torch.Tensor,
                    noise_spec: Optional[torch.Tensor],
                    noisy_spec: torch.Tensor,
                    num_samples: int) -> torch.Tensor:
    """Sample-mean + mask combination -> (B, F, T, 2) estimate.

    speech_spec / noise_spec: decoder spectra (B*S, F, T, 2) float32;
    noisy_spec: (B, F, T, 2). The masks run in float32 complex; as in
    the JAX package, the 1e-10 of `complex_mask` is added to the real
    part of the complex denominator.
    """
    with span("idccrn.mask"):
        s = _sample_mean(speech_spec, num_samples)
        y = noisy_spec
        if outtype == "clean_direct" or noise_spec is None:
            return s
        n = _sample_mean(noise_spec, num_samples)
        if outtype == "real_imag_mask":
            rm = s[..., 0] ** 2 / (s[..., 0] ** 2 + n[..., 0] ** 2 + 1e-10)
            im = s[..., 1] ** 2 / (s[..., 1] ** 2 + n[..., 1] ** 2 + 1e-10)
            return torch.stack([rm * y[..., 0], im * y[..., 1]], dim=-1)
        sc, nc, yc = _complex(s), _complex(n), _complex(y)
        if outtype == "complex_mask":
            return _real_imag(sc / (sc + nc + 1e-10) * yc)
        if outtype == "phase_mask":
            s_mag, s_ph = sc.abs(), sc.angle()
            mask = (s_mag / (s_mag + nc.abs() + 1e-10)
                    * torch.cos(s_ph - yc.angle()))
            return _real_imag(mask * yc.abs() * torch.exp(1j * s_ph))
        raise ValueError(f"unknown outtype {outtype}")


class BucketedEnhancer:
    """The serving entry every enhancer shares: utterances sorted by
    length, `batch_size` at a time, each batch padded to one bucket
    (`bucket_length`, a subclass's; `_fill` writes one row, zeros after
    the utterance by default), copied in, run (`_run`, a subclass's, given
    each row's length in samples) and copied out, each answer trimmed to
    its utterance's length.

    counters: host ints, always kept, summed over every batch `_bucketed`
    has padded: `batches`, `rows`, `real_frames` (`_frames` of each row's
    length) and `padded_frames` (rows x the bucket's len // hop).
    """

    hop: int
    bucket_frames: int
    device: torch.device

    def __init__(self):
        self.counters = dict.fromkeys(
            ("batches", "rows", "real_frames", "padded_frames"), 0)

    def new_generator(self, seed: int = 0) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def bucket_length(self, n_samples: int) -> int:
        raise NotImplementedError

    def _frames(self, n_samples: int) -> int:
        return n_samples // self.hop + 1

    def _fill(self, row: np.ndarray, wav: np.ndarray) -> None:
        row[: len(wav)] = wav

    def _count(self, lengths: Sequence[int], bucket: int) -> None:
        c = self.counters
        c["batches"] += 1
        c["rows"] += len(lengths)
        c["real_frames"] += sum(self._frames(n) for n in lengths)
        c["padded_frames"] += len(lengths) * (bucket // self.hop)

    def _run(self, wav: torch.Tensor, generator: Optional[torch.Generator],
             lengths: torch.Tensor) -> torch.Tensor:
        """The program on a padded batch; `lengths`, a host tensor, the
        rows' lengths in samples."""
        raise NotImplementedError

    def _bucketed(self, wavs: Sequence[np.ndarray], batch_size: int):
        """Sorted by length, batch_size at a time, each batch padded to
        one bucket: yields (indices into wavs, (b, bucket) batch, the
        rows' lengths)."""
        order = np.argsort([len(w) for w in wavs])
        for i in range(0, len(order), batch_size):
            with span("idccrn.pad"):
                chunk = order[i : i + batch_size]
                lengths = [len(wavs[j]) for j in chunk]
                bucket = self.bucket_length(max(lengths))
                batch = np.zeros((len(chunk), bucket), np.float32)
                for r, j in enumerate(chunk):
                    self._fill(batch[r], wavs[j])
                self._count(lengths, bucket)
            yield chunk, batch, lengths

    # -- public API --------------------------------------------------------
    def enhance_batch(self, wavs, generator: Optional[torch.Generator] = None,
                      lengths: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
        """Enhance a padded batch (B, L) (numpy or tensor); L should be a
        bucket length, `lengths` the rows' lengths in samples (None: L
        each). Returns a tensor on the enhancer's device, so a caller can
        chain batches without host copies. In a data-parallel group every
        rank passes the same batch, enhances its rows and returns the
        whole batch's output."""
        generator = self.new_generator() if generator is None else generator
        with span("idccrn.copy_in"):
            wav = torch.as_tensor(wavs, dtype=torch.float32,
                                  device=self.device)
        lengths = torch.as_tensor([wav.shape[1]] * wav.shape[0]
                                  if lengths is None else lengths)
        n = distributed.world()
        if n == 1:
            return self._run(wav, generator, lengths)
        # data-parallel: zero rows up to a multiple of the world (as the
        # JAX package pads for its mesh), this rank's rows enhanced with
        # the un-padded batch's draws, the ranks' outputs gathered
        b = wav.shape[0]
        wav = torch.cat([wav, wav.new_zeros((-b % n, wav.shape[1]))])
        lengths = shard_batch(torch.cat(
            [lengths, lengths.new_full((-b % n,), wav.shape[1])]))
        with padded_rows(b):
            out = self._run(shard_batch(wav), generator, lengths)
        with torch.inference_mode():
            return distributed.gather_rows(out)[:b]

    def enhance_utterances(self, wavs: Sequence[np.ndarray],
                           batch_size: int = 8,
                           generator: Optional[torch.Generator] = None
                           ) -> List[np.ndarray]:
        """Length-bucketed padded batched enhancement of a wav list.

        One generator advances through the batches; each output is
        trimmed to its input's length.
        """
        generator = self.new_generator() if generator is None else generator
        results: List[Optional[np.ndarray]] = [None] * len(wavs)
        for chunk, batch, lengths in self._bucketed(wavs, batch_size):
            with span("idccrn.enhance.batch"):
                out = self.enhance_batch(batch, generator, lengths)
                with span("idccrn.copy_out"):
                    out = out.cpu().numpy()
            for r, j in enumerate(chunk):
                results[j] = out[r, : min(len(wavs[j]), out.shape[1])]
        return results  # type: ignore[return-value]


class Enhancer(BucketedEnhancer):
    """NSVAE encoder + pretrained/fine-tuned decoder(s) speech enhancer.

    enc_state / dec_state / noise_dec_state are state_dicts under the
    reference's names (a port module's `state_dict()`, or a reference
    checkpoint). The models run on `device`: CUDA unless the caller asks
    for another.

    latent_to_use=1 decodes the speech latent only (outtype must be
    'clean_direct'); 2 needs a dual-latent encoder (latent_num=2) and the
    noise decoder's weights, and outtype picks the mask combination.
    'clean_direct' with latent_to_use=2 returns the speech decode and
    skips the noise decoder, whose output it would discard.

    sample_chunks: decode num_samples in this many sequential chunks
    instead of one B*S batch — same outputs, peak decoder memory divided
    by sample_chunks.

    counters (`BucketedEnhancer`): `real_frames` counts each row's
    len // hop + 1 frames, `padded_frames` the bucket's len // hop a row.
    """

    def __init__(self, enc_cfg: DccrnConfig, dec_cfg: DccrnConfig,
                 enc_state: Mapping[str, torch.Tensor],
                 dec_state: Mapping[str, torch.Tensor],
                 noise_dec_state: Optional[Mapping[str, torch.Tensor]] = None,
                 num_samples: int = 10, outtype: str = "clean_direct",
                 latent_to_use: int = 1, pad_mode: str = "sig",
                 bucket_frames: int = DEFAULT_BUCKET_FRAMES,
                 sample_chunks: int = 1, device: DeviceLike = None):
        if latent_to_use not in (1, 2):
            raise ValueError(f"latent_to_use must be 1 or 2, got "
                             f"{latent_to_use}")
        if outtype not in OUTTYPES:
            raise ValueError(f"unknown outtype {outtype!r}; one of {OUTTYPES}")
        if latent_to_use == 1 and outtype != "clean_direct":
            raise ValueError(f"outtype={outtype!r} needs the noise latent: "
                             "pass latent_to_use=2")
        if latent_to_use == 2:
            if enc_cfg.latent_num != 2:
                raise ValueError(
                    "latent_to_use=2 requires a dual-latent encoder "
                    f"(enc_cfg.latent_num={enc_cfg.latent_num})")
            if noise_dec_state is None:
                raise ValueError(
                    "latent_to_use=2 requires noise decoder weights")
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
        self.noise_decoder = None
        if latent_to_use == 2:
            self.noise_decoder = VaeDecoder(dec_cfg, device=self.device)
            self.noise_decoder.load_state_dict(noise_dec_state)
        self.num_samples = num_samples
        self.outtype = outtype
        self.pad_mode = pad_mode
        self.bucket_frames = bucket_frames
        self.sample_chunks = sample_chunks
        self.hop = enc_cfg.stft.hop
        super().__init__()

    @torch.inference_mode()
    def forward(self, wav: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Eps = None, noise_n: Eps = None) -> torch.Tensor:
        """The enhancement program: (B, L) -> (B, (T - 1) * hop).

        noise / noise_n: optional (eps_r, eps_i) for the speech / the
        noise latent's draws, each (B, num_samples, T, zdim); a latent
        without one draws from `generator`.
        """
        return self.program(wav, generator, noise, noise_n)

    def program(self, wav: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Eps = None, noise_n: Eps = None) -> torch.Tensor:
        """`forward` outside inference mode: the body `eval/export.py`
        traces, so the live and exported programs share one body."""
        s = self.enc_cfg.stft
        ns, chunks = self.num_samples, self.sample_chunks
        out = self.encoder(wav, num_samples=ns, generator=generator,
                           noise=noise, noise_n=noise_n)
        skips = split_noisy_skips(out.skips, self.enc_cfg, "speech")
        direct = self.outtype == "clean_direct"
        nskips = (None if direct else
                  split_noisy_skips(out.skips, self.enc_cfg, "noise"))

        def speech(z, samples):
            return self.decoder(out.stft_x, z, skips, num_samples=samples,
                                pad_mode=self.pad_mode)

        def noise_spec(z, samples):
            return self.noise_decoder(out.stft_x, z, nskips,
                                      num_samples=samples,
                                      pad_mode=self.pad_mode)[1]

        if chunks == 1:
            recon, pred_s = speech(out.z_speech, ns)
            if direct:
                return _sample_mean(recon, ns)
            est = combine_outputs(self.outtype, pred_s,
                                  noise_spec(out.z_noise, ns), out.stft_x, ns)
            with span("idccrn.istft"):
                return istft(est, s.n_fft, s.hop, s.win_length)
        # rows are batch-major, sample-minor: (B*S, ...) -> (B, S, ...);
        # equal chunk sizes, so the mean of chunk means is the full mean
        sc = ns // chunks
        b = wav.shape[0]

        def z_chunk(z: torch.Tensor, c: int) -> torch.Tensor:
            zb = z.reshape((b, ns) + tuple(z.shape[1:]))
            return zb[:, c * sc : (c + 1) * sc].reshape(
                (-1,) + tuple(z.shape[1:]))

        if direct:
            parts = [_sample_mean(speech(z_chunk(out.z_speech, c), sc)[0], sc)
                     for c in range(chunks)]
            return torch.stack(parts).mean(dim=0)
        s_parts, n_parts = [], []
        for c in range(chunks):
            pred_s = speech(z_chunk(out.z_speech, c), sc)[1]
            pred_n = noise_spec(z_chunk(out.z_noise, c), sc)
            s_parts.append(_sample_mean(pred_s, sc))
            n_parts.append(_sample_mean(pred_n, sc))
        est = combine_outputs(self.outtype, torch.stack(s_parts).mean(dim=0),
                              torch.stack(n_parts).mean(dim=0), out.stft_x,
                              num_samples=1)
        with span("idccrn.istft"):
            return istft(est, s.n_fft, s.hop, s.win_length)

    def bucket_length(self, n_samples: int) -> int:
        return bucket_pad_length(n_samples, self.enc_cfg.stft.hop,
                                 self.bucket_frames)

    def _run(self, wav, generator, lengths):
        return self.forward(wav, generator)

    @torch.inference_mode()
    def encode_latents(self, wavs: Sequence[np.ndarray], batch_size: int = 8,
                       generator: Optional[torch.Generator] = None):
        """Posterior means for latent diagnostics: (speech_mus, noise_mus),
        lists of (T, zdim, 2) numpy arrays, each trimmed to its
        utterance's real frame count (noise list empty for latent_num=1)."""
        generator = self.new_generator() if generator is None else generator
        hop = self.enc_cfg.stft.hop
        speech, noise = [], []
        for chunk, batch, _ in self._bucketed(wavs, batch_size):
            out = self.encoder(torch.from_numpy(batch).to(self.device),
                               num_samples=1, generator=generator)
            mus = [torch.stack([g.mu_r, g.mu_i], dim=-1).cpu().numpy()
                   for g in (out.gauss_speech, out.gauss_noise)
                   if g is not None]
            for r, j in enumerate(chunk):
                # the utterance's real frames: padded silence would bias
                # the covariance diagnostics
                frames = len(wavs[j]) // hop + 1
                speech.append(mus[0][r, :frames])
                if len(mus) == 2:
                    noise.append(mus[1][r, :frames])
        return speech, noise


class CmganEnhancer(BucketedEnhancer):
    """CMGAN's generator (`models/cmgan.py` TSCNet) served as upstream's
    `evaluation.py` serves one utterance, a batch at a time through the
    shared bucketing entry.

    A row: level-normalised by c = sqrt(L / sum x^2) over its L real
    samples; padded as upstream pads the utterance alone (up to a
    multiple of the hop with its own first samples), then with its
    reflection for the last frame's half window (what the STFT's centring
    would add at the utterance's end), then zeros to the bucket; STFT
    (periodic Hamming, n_fft = win_length, centred), |X|^0.3 at X's
    phase, the generator given the row's ceil(L / hop) + 1 real frames,
    the compression undone, iSTFT, divided by c. Buckets are multiples of
    `bucket_frames` STFT frames that hold those frames and the reflection.
    An utterance whose hop-padded length passes `cut_len` (16 s at 16
    kHz), which upstream would split into rows, is refused.

    `state` is a TSCNet state dict under upstream's names; `compute`
    'bf16' or 'f32' (`TSCNet.prepare`; the card's attention kernel takes
    bf16 alone). counters: besides `BucketedEnhancer`'s (real frames
    ceil(L / hop) + 1 a row), `attn_scores`: the attention scores the real
    lengths need, summed over the TSCBs of rows x heads x n_q x n_k, both
    axes.
    """

    def __init__(self, state: Mapping[str, torch.Tensor],
                 num_channel: int = 64, num_tscb: int = 4, heads: int = 4,
                 max_pos_emb: int = 512, n_fft: int = 400, hop: int = 100,
                 compute: str = "bf16",
                 bucket_frames: int = DEFAULT_BUCKET_FRAMES,
                 cut_len: int = 16000 * 16, device: DeviceLike = None):
        if compute not in ("bf16", "f32"):
            raise ValueError(f"compute must be 'bf16' or 'f32', got "
                             f"{compute!r}")
        self.device = resolve_device(device)
        self.n_fft, self.hop = n_fft, hop
        self.bucket_frames, self.cut_len = bucket_frames, cut_len
        self.heads = heads
        self.model = TSCNet(num_channel, n_fft // 2 + 1, num_tscb, heads,
                            max_pos_emb, device=self.device)
        self.model.load_state_dict(state)
        self.model.prepare(torch.bfloat16 if compute == "bf16"
                           else torch.float32)
        super().__init__()
        self.counters["attn_scores"] = 0

    def _frames(self, n_samples: int) -> int:
        return -(-n_samples // self.hop) + 1

    def bucket_length(self, n_samples: int) -> int:
        """Samples of the smallest bucket for an n_samples utterance: its
        frames and the reflection's, rounded up to `bucket_frames`."""
        if -(-n_samples // self.hop) * self.hop > self.cut_len:
            raise ValueError(
                f"an utterance of {n_samples} samples passes cut_len "
                f"{self.cut_len}: upstream splits it into rows, which this "
                "enhancer does not")
        need = self._frames(n_samples) + -(-(self.n_fft // 2) // self.hop)
        frames = -(-need // self.bucket_frames) * self.bucket_frames
        return (frames - 1) * self.hop

    def _fill(self, row: np.ndarray, wav: np.ndarray) -> None:
        n = len(wav)
        padded = -(-n // self.hop) * self.hop
        tail = self.n_fft // 2
        if padded <= tail + 1:
            raise ValueError(f"an utterance of {n} samples is not longer "
                             f"than the STFT's half window ({tail})")
        row[:n] = wav
        row[n:padded] = wav[: padded - n]
        # x[padded + k] = x[padded - 2 - k]: the centred STFT's reflection
        row[padded: padded + tail] = row[padded - 2 - np.arange(tail)]

    def _count(self, lengths: Sequence[int], bucket: int) -> None:
        super()._count(lengths, bucket)
        f = self.n_fft // 4 + 1          # bins after the encoder's stride 2
        per_tscb = sum(self.heads * (f * t * t + t * f * f)
                       for t in map(self._frames, lengths))
        self.counters["attn_scores"] += self.model.num_tscb * per_tscb

    @torch.inference_mode()
    def forward(self, wav: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) padded batch, the rows' lengths in samples (B,) (None:
        L) -> (B, L) enhanced."""
        hop, n_fft = self.hop, self.n_fft
        with span("idccrn.copy_in"):
            lengths = (torch.full((wav.shape[0],), wav.shape[1])
                       if lengths is None else lengths).to(wav.device)
        with span("idccrn.cmgan.stft"):
            real = torch.arange(wav.shape[1], device=wav.device)[None, :] \
                < lengths[:, None]
            c = torch.sqrt(lengths / (wav * wav * real).sum(-1))[:, None]
            spec = stft(wav * c, n_fft, hop, n_fft, window="hamming")
            x = _power_law(spec[..., 0], spec[..., 1], 0.3)
            x = torch.stack(x, dim=1).transpose(2, 3)     # (B, 2, T, F)
            frames = (lengths + hop - 1) // hop + 1
        re, im = self.model(x, frames)
        with span("idccrn.cmgan.istft"):
            re, im = _power_law(re[:, 0].transpose(1, 2),
                                im[:, 0].transpose(1, 2), 1 / 0.3)
            out = istft(torch.stack([re, im], dim=-1), n_fft, hop, n_fft,
                        window="hamming", frames=frames)
            return out / c

    def _run(self, wav, generator, lengths):
        return self.forward(wav, lengths)


def _power_law(re: torch.Tensor, im: torch.Tensor, p: float):
    """|X|^p at X's phase, as (re, im), in float32."""
    spec = torch.complex(re.float(), im.float())
    mag, phase = spec.abs() ** p, spec.angle()
    return mag * torch.cos(phase), mag * torch.sin(phase)
