"""Streaming (chunked, stateful) causal enhancement.

Mirrors `idccrn_vae_tpu/eval/streaming.py`. One chunk step consumes N
STFT frames (N*hop samples) and emits N*hop enhanced samples, carrying
all temporal state explicitly in a `StreamState`:

  * the (n_fft - hop) padded-signal tail for STFT framing,
  * one input time-column per causal conv / transposed-conv layer
    (kernel_t = 2 needs exactly one frame of left context),
  * the complex-LSTM (h, c) per layer, each (2, 2B, H): weight set
    (re, im) first, then the stacked batch [xr; xi],
  * the overlap-add numerator/envelope tails for the ISTFT.

Latency = chunk duration + (n_fft - hop) samples: emitted sample q
corresponds to input sample q - (n_fft - hop). Against the offline
causal forward, the stream head is zero-padded rather than
reflect-padded, frames sit (n_fft - hop) rather than n_fft/2 ahead of
the signal, and the latent is the posterior mean z = mu.

Precision: the chunk step runs in float32 whatever `cfg.compute` says,
as the JAX chunk step passes no compute dtype to its conv, LSTM and
dense calls.
"""

from __future__ import annotations

from typing import List, Mapping, NamedTuple, Optional, Tuple

import torch

from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.models.config import (
    DccrnConfig,
    bottleneck_dims,
    freq_sizes,
)
from idccrn_vae_torch.models.dccrn import SupervisedDccrn
from idccrn_vae_torch.models.modules import (
    apply_datanorm,
    cpack_concat,
    flatten_bottleneck,
    mask_reconstruct,
    prelu,
    undo_datanorm,
    unflatten_bottleneck,
)
from idccrn_vae_torch.models.nsvae import NsvaeEncoder, split_noisy_skips
from idccrn_vae_torch.models.vae import (
    HEADS,
    VaeDecoder,
    apply_fc_head,
    parse_sliced_head,
)
from idccrn_vae_torch.ops.conv import complex_conv2d, complex_conv_transpose2d
from idccrn_vae_torch.ops.stft import _overlap_add, hann_window, ola_envelope
from idccrn_vae_torch.utils.profiling import span

MODELS = ("nsvae", "supervised")


class StreamState(NamedTuple):
    pad_tail: torch.Tensor             # (B, n_fft - hop) padded-signal tail
    enc_tails: List[torch.Tensor]      # per conv layer: (B, F_in, 1, 2C_in)
    lstm_state: list                   # per layer: (h, c), each (2, 2B, H)
    dec_tails: List[torch.Tensor]      # per tconv layer input col, with skips
    ola_num: torch.Tensor              # (B, n_fft - hop)
    ola_env: torch.Tensor              # (n_fft - hop,)


class StreamingEnhancer:
    """Real-time enhancement, chunk by chunk.

    model='nsvae': `enc_state` is an NsvaeEncoder state_dict and
    `dec_state` a (pretrained/fine-tuned) VaeDecoder state_dict; the
    latent is z = mu. model='supervised': `enc_state` is a
    SupervisedDccrn state_dict and `dec_state` is None. datanorm:
    optional per-bin (mean, std), each (F, 2), of a datanorm-trained
    checkpoint (NSVAE encoders never use it). The models run on
    `device`: CUDA unless the caller asks for another.
    """

    def __init__(self, enc_cfg: DccrnConfig, dec_cfg: DccrnConfig,
                 enc_state: Mapping[str, torch.Tensor],
                 dec_state: Optional[Mapping[str, torch.Tensor]] = None,
                 chunk_frames: int = 10, model: str = "nsvae",
                 datanorm=None, pad_mode: str = "sig",
                 device: DeviceLike = None):
        if not (enc_cfg.causal and dec_cfg.causal):
            raise ValueError("streaming needs causal configs")
        if model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, got {model!r}")
        if (model == "supervised") != (dec_state is None):
            raise ValueError("model='nsvae' needs dec_state; "
                             "model='supervised' takes its one state_dict "
                             "as enc_state and dec_state=None")
        self.device = resolve_device(device)
        self.enc_cfg, self.dec_cfg = enc_cfg, dec_cfg
        self.model = model
        if model == "supervised":
            net = SupervisedDccrn(enc_cfg, device=self.device)
            net.load_state_dict(enc_state)
            layers = net.layers
            self.encoders, self.lstm = layers.encoders, layers.lstms[0]
            self.dense, self.decoders = layers.dense, layers.decoders
            self.heads = None
        else:
            enc = NsvaeEncoder(enc_cfg, device=self.device)
            enc.load_state_dict(enc_state)
            dec = VaeDecoder(dec_cfg, device=self.device)
            dec.load_state_dict(dec_state)
            self.encoders, self.lstm = enc.encoders, enc.lstms[0]
            self.dense, self.decoders = dec.dense, dec.decoders
            self.heads = ({h: getattr(enc, f"speech_dense_{h}")
                           for h in HEADS}
                          if enc_cfg.latent == "fc" else None)
        # the offline decoder's rule: 'zero'-skip checkpoints and runtime
        # decoders called with pad_mode='zero' see zero skip content
        self.zero_skips = (
            dec_cfg.skip_mode == "zero"
            or (dec_cfg.skip_mode == "runtime" and pad_mode == "zero"))
        self.datanorm = None
        if datanorm is not None:
            self.datanorm = tuple(
                torch.as_tensor(d, dtype=torch.float32, device=self.device)
                for d in datanorm)
        s = enc_cfg.stft
        self.n = chunk_frames
        self.hop, self.n_fft, self.win_length = s.hop, s.n_fft, s.win_length
        self.chunk_samples = chunk_frames * s.hop
        self.window = hann_window(s.win_length, s.n_fft, self.device,
                                   torch.float32)

    # -- state -------------------------------------------------------------
    def init_state(self, batch: int) -> StreamState:
        cfg = self.enc_cfg
        tail = self.n_fft - self.hop
        zeros = lambda *shape: torch.zeros(shape, device=self.device)
        freqs = (cfg.stft.freq_bins,) + freq_sizes(cfg)
        # conv weights are (Co, Ci, kh, kw), tconv weights (Ci, Co, kh, kw)
        enc_tails = [zeros(batch, freqs[i], 1,
                           2 * st.conv.conv_re.weight.shape[1])
                     for i, st in enumerate(self.encoders)]
        hidden = self.lstm.lstm_re.weight_hh_l0.shape[1]
        lstm_state = [tuple(zeros(2, 2 * batch, hidden) for _ in range(2))
                      for _ in range(cfg.lstm_layers)]
        dec_freqs = tuple(reversed(freqs))[:-1]  # input F per decoder stage
        dec_tails = [zeros(batch, dec_freqs[i], 1,
                           2 * st.transconv.tconv_re.weight.shape[0])
                     for i, st in enumerate(self.decoders)]
        return StreamState(pad_tail=zeros(batch, tail), enc_tails=enc_tails,
                           lstm_state=lstm_state, dec_tails=dec_tails,
                           ola_num=zeros(batch, tail), ola_env=zeros(tail))

    # -- one chunk ---------------------------------------------------------
    def _chunk_step(self, state: StreamState, chunk: torch.Tensor
                    ) -> Tuple[torch.Tensor, StreamState]:
        cfg, dcfg = self.enc_cfg, self.dec_cfg
        n, hop, n_fft = self.n, self.hop, self.n_fft
        tail = n_fft - hop

        # 1. frame + STFT: (B, tail + N*hop) -> N frames of n_fft
        with span("idccrn.stft"):
            buf = torch.cat([state.pad_tail, chunk], dim=1)
            frames = buf.unfold(-1, n_fft, hop) * self.window  # (B, N, n_fft)
            spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
            stft_x = torch.view_as_real(spec).transpose(1, 2)  # (B, F, N, 2)
            if self.datanorm is not None:
                stft_x = apply_datanorm(stft_x, *self.datanorm)

        # 2. encoder conv stack with carried time columns
        with span("idccrn.enc"):
            x = stft_x
            new_enc_tails, skips = [], []
            for st, t in zip(self.encoders, state.enc_tails):
                xin = torch.cat([t, x], dim=2)  # (B, F, 1+N, 2C)
                new_enc_tails.append(xin[:, :, -1:])
                c = st.conv
                x = complex_conv2d(xin, c.conv_re.weight, c.conv_im.weight,
                                   c.conv_re.bias, c.conv_im.bias, cfg.stride,
                                   (cfg.freq_pad, 0), causal=False)
                x = prelu(st.bn(x), st.prelu.weight)
                skips.append(x)
            # double/adapt noisy encoders emit doubled skip channels; the
            # pretrained-geometry decoder takes the speech half
            if self.model == "nsvae":
                skips = split_noisy_skips(skips, cfg, "speech")

        # 3. LSTM with carried state -> posterior mean, or for the
        # supervised model the bottleneck features themselves
        lstm_out, new_lstm_state = self.lstm(
            flatten_bottleneck(x), state=state.lstm_state, return_state=True)
        if self.model == "supervised":
            z = lstm_out
        else:
            with span("idccrn.latent"):
                gauss = (apply_fc_head(lstm_out, self.heads)
                         if self.heads is not None
                         else parse_sliced_head(lstm_out, cfg.zdim))
                z = torch.cat([gauss.mu_r, gauss.mu_i], dim=-1)

        # 4. decoder with carried time columns
        with span("idccrn.dec"):
            c, f = bottleneck_dims(dcfg)
            p_map = unflatten_bottleneck(self.dense(z), c, f)
            nst = dcfg.num_stages
            new_dec_tails = []
            for i, (st, t) in enumerate(zip(self.decoders, state.dec_tails)):
                if dcfg.skip_mode != "none" and i in dcfg.skip_to_use:
                    sk = skips[nst - 1 - i]
                    p_map = cpack_concat(
                        p_map, torch.zeros_like(sk) if self.zero_skips else sk)
                xin = torch.cat([t, p_map], dim=2)
                new_dec_tails.append(xin[:, :, -1:])
                tc = st.transconv
                p_map = complex_conv_transpose2d(
                    xin, tc.tconv_re.weight, tc.tconv_im.weight,
                    tc.tconv_re.bias, tc.tconv_im.bias, dcfg.stride,
                    (dcfg.freq_pad, 0), causal=False)
                # a non-causal tconv on 1+N columns gives 2+N; the stream's
                # columns are 1..N (column 0 needs the context before the
                # tail, the last is the causal trim)
                p_map = prelu(st.bn(p_map[:, :, 1 : n + 1]), st.prelu.weight)

        with span("idccrn.istft"):
            # 5. mask / real_imag reconstruction on this chunk's frames
            est = (mask_reconstruct(p_map, stft_x)
                   if dcfg.recon_type == "mask" else p_map)
            if self.datanorm is not None:
                est = undo_datanorm(est, *self.datanorm)

            # 6. streaming inverse STFT with carried overlap-add tails
            cplx = torch.view_as_complex(est.contiguous()).transpose(1, 2)
            oframes = torch.fft.irfft(cplx, n=n_fft, dim=-1) * self.window
            num = _overlap_add(oframes, hop)  # (B, N*hop + tail)
            num[:, :tail] += state.ola_num
            env = ola_envelope(n, n_fft, hop, self.win_length, self.device,
                               torch.float32).clone()
            env[:tail] += state.ola_env
            m = n * hop
            out = num[:, :m] / env[:m].clamp_min(1e-8)
        new_state = StreamState(
            pad_tail=buf[:, -tail:], enc_tails=new_enc_tails,
            lstm_state=new_lstm_state, dec_tails=new_dec_tails,
            ola_num=num[:, m:], ola_env=env[m:])
        return out, new_state

    # -- public ------------------------------------------------------------
    @torch.inference_mode()
    def process_chunk(self, state: StreamState, chunk
                      ) -> Tuple[torch.Tensor, StreamState]:
        """chunk (B, chunk_samples) -> (enhanced (B, chunk_samples), state)."""
        with span("idccrn.stream.chunk"):
            with span("idccrn.copy_in"):
                chunk = torch.as_tensor(chunk, dtype=torch.float32,
                                        device=self.device)
            if chunk.shape[1] != self.chunk_samples:
                raise ValueError(f"chunk has {chunk.shape[1]} samples, the "
                                 f"stream takes {self.chunk_samples}")
            return self._chunk_step(state, chunk)

    def stream(self, wav) -> torch.Tensor:
        """Run a full (B, L) signal (numpy or tensor) through chunked calls.

        The final partial chunk (L % chunk_samples) is zero-padded,
        processed, and the output trimmed back to L. Returns a tensor on
        the streamer's device."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        b, total = wav.shape
        m = self.chunk_samples
        n_chunks = -(-total // m)
        wav = torch.nn.functional.pad(wav, (0, n_chunks * m - total))
        state = self.init_state(b)
        outs = []
        for k in range(n_chunks):
            out, state = self.process_chunk(state, wav[:, k * m:(k + 1) * m])
            outs.append(out)
        return torch.cat(outs, dim=1)[:, :total]
