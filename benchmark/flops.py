"""Useful FLOPs of the model's equations, counted from a configuration's
shapes and the work done, whatever implements them.

Counted, at 2 FLOPs a multiply-add:
  conv    a complex conv as its (2 Cin) x (2 Cout) real block conv, at
          every output position: rows x F_out x T x 2Cin x 2Cout x kh x kw
  tconv   a complex transposed conv's useful multiply-adds, those whose
          input and output both lie inside the kept map: as
          `profile_decoder.macs()`, half of rows x F_out x T x 2Cin x
          2Cout x kh x kw (stride 2 in frequency leaves every second
          output row half the taps). A skip's half runs once per
          utterance where the S samples share it.
  LSTM    the four real LSTMs of each complex LSTM layer at every frame:
          4 x rows x T x 4H x (In + H)
  dense   the decoder's two real linears, zdim -> C x F, at every frame
Not counted: the elementwise passes (batch norm, PReLU, the LSTM's
gates, the reparameterisation, the masks), the FFTs of the STFT and its
inverse, the losses and the optimizer.

A training step counts the forward three times: each product's backward
is two of the same size (the gradient of its input and of its weight),
less two that nothing needs: the gradient of the first conv's input (the
spectrum) and, in each LSTM layer, that of the zero state before the
first frame.

`tconv="scatter"` counts each transposed conv as FlopCounterMode does,
every input position times the whole kernel; the tests use it to hold
this count to FlopCounterMode's of the port's operations.
"""

from __future__ import annotations

from typing import Sequence

from benchmark.reference.model import Geometry


def _conv(geo: Geometry, rows: int, t: int, double: bool) -> tuple:
    """(all encoder conv MACs, the first conv's)."""
    kh, kw = geo.kernel
    f = geo.freqs()
    macs = [rows * f[i + 1] * t * 4 * cin * cout * kh * kw
            for i, (cin, cout) in enumerate(geo.encoder_plan(double))]
    return sum(macs), macs[0]


def _lstm(geo: Geometry, rows: int, t: int, double: bool,
          latents: int) -> int:
    c, f = geo.bottleneck(double)
    hid = 3 * geo.zdim * latents
    total, inp = 0, c * f
    for _ in range(geo.lstm_layers):
        total += 4 * rows * t * 4 * hid * (inp + hid)
        inp = hid
    return total


def _tconv(geo: Geometry, rows: int, t: int, cin: int, cout: int,
           f_in: int, f_out: int, tconv: str) -> float:
    kh, kw = geo.kernel
    if tconv == "scatter":
        return rows * f_in * t * 4 * cin * cout * kh * kw
    return rows * f_out * t * 4 * cin * cout * kh * kw / 2


def decoder_macs(geo: Geometry, rows: int, skip_rows: int, t: int,
                 tconv: str = "useful") -> float:
    """One decoder over `rows` latent rows; the skip halves at
    `skip_rows` (0: skips padded with zeros, nothing to multiply)."""
    c, f = geo.bottleneck(False)
    total = 2 * rows * t * geo.zdim * c * f
    freqs = list(reversed(geo.freqs()))
    for i, (cx, cs, cout) in enumerate(geo.decoder_plan()):
        total += _tconv(geo, rows, t, cx, cout, freqs[i], freqs[i + 1], tconv)
        if cs and skip_rows:
            total += _tconv(geo, skip_rows, t, cs, cout, freqs[i],
                            freqs[i + 1], tconv)
    return total


def serve_decoder_flops(config: dict, batch: int, frames: int,
                        num_samples: int, tconv: str = "useful") -> float:
    """FLOPs of every decoder the out-type runs in one enhancement
    forward of (batch, frames)."""
    decoders = 1 if config["serve"]["outtype"] == "clean_direct" else 2
    return 2.0 * decoders * decoder_macs(Geometry.of(config),
                                         batch * num_samples, batch, frames,
                                         tconv)


def serve_flops(config: dict, batch: int, frames: int, num_samples: int,
                tconv: str = "useful") -> float:
    """FLOPs of one enhancement forward of (batch, frames): the encoder
    and every decoder the out-type runs."""
    geo = Geometry.of(config)
    m = config["model"]
    double = m["channel_mode"] == "double"
    macs = _conv(geo, batch, frames, double)[0]
    macs += _lstm(geo, batch, frames, double, m["latent_num"])
    return 2.0 * macs + serve_decoder_flops(config, batch, frames,
                                            num_samples, tconv)


def train_forward_macs(config: dict, batch: int, frames: int,
                       num_samples: int, tconv: str = "useful") -> tuple:
    """(forward MACs, the backward MACs nothing needs) of a CVAE
    training step."""
    geo = Geometry.of(config)
    conv, first = _conv(geo, batch, frames, False)
    skip_rows = 0 if config["train"]["skip_mode"] == "zero" else batch
    macs = (conv + _lstm(geo, batch, frames, False, 1)
            + decoder_macs(geo, batch * num_samples, skip_rows, frames,
                           tconv))
    hid = 3 * geo.zdim
    h0 = geo.lstm_layers * 4 * batch * 4 * hid * hid
    return macs, first + h0


def train_step_flops(config: dict, batch: int, frames: int,
                     num_samples: int, tconv: str = "useful") -> float:
    """FLOPs of one CVAE training step: forward and backward."""
    macs, unneeded = train_forward_macs(config, batch, frames, num_samples,
                                        tconv)
    return 2.0 * (3 * macs - unneeded)


def bucket_frames(lengths: Sequence[int], batch: int, hop: int,
                  bucket: int) -> list:
    """(rows, frames) of each batch that a length-sorted, bucketed pass
    over utterances of `lengths` runs: frames (L // hop + 1) rounded up
    to a multiple of `bucket`, plus the STFT's extra frame."""
    order = sorted(lengths)
    out = []
    for i in range(0, len(order), batch):
        chunk = order[i: i + batch]
        frames = max(chunk) // hop + 1
        frames = -(-frames // bucket) * bucket
        out.append((len(chunk), frames + 1))
    return out
