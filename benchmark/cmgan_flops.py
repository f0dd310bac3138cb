"""Useful work of CMGAN's generator (TSCNet) on real lengths, counted
from a configuration's shapes, whatever implements it.

An utterance of L samples has T = ceil(L / hop) + 1 real frames (the
frames `evaluation.py` gives it); the padding of a batch is not counted.
At 2 FLOPs a multiply-add, with F = n_fft / 2 + 1 bins, F' = (F + 1) / 2
after the encoder's stride, C channels, H heads of d:
  convs       the 1x1 input conv, the dense blocks (kernel (2, 3), inputs
              C, 2C, 3C, 4C), the strided encoder conv, the sub-pixel
              convs and the decoders' last convs, at every output
              position
  conformers  each over T F' tokens: two FFNs (C -> 4C -> C), q, k, v
              and the output projection, the conv module's 1x1 convs
              (C -> 4C, 2C -> C) and its depthwise conv (2C x 31)
  attention   per row and head, 6 n_q n_k d: q . k, q . E[i - j] and
              P v; the time axis has F' rows of n = T, the frequency
              axis T rows of n = F'
Not counted: the norms, activations, GLU, masks, the STFT, the
compression and the phase.

Attention bytes (`attn_bytes`): q, k, v and the output once each, at the
operands' width, and the embedding once per call.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence


def _shapes(config: dict):
    m, s = config["model"], config["stft"]
    f = s["n_fft"] // 2 + 1
    return (f, (f + 1) // 2, m["num_channel"], m["heads"],
            m["num_channel"] // m["heads"], m["num_tscb"],
            m["conv_kernel_size"])


def frames(config: dict, n_samples: int) -> int:
    return -(-n_samples // config["stft"]["hop"]) + 1


def attn_pairs(config: dict, t: int) -> int:
    """Score pairs of one utterance of t frames, every TSCB, both axes,
    every head: rows x heads x n_q x n_k."""
    _, f2, _, h, _, blocks, _ = _shapes(config)
    return blocks * h * (f2 * t * t + t * f2 * f2)


def utterance_flops(config: dict, t: int) -> Dict[str, float]:
    """{"total", "attn"} FLOPs of one utterance of t real frames."""
    f, f2, c, h, d, blocks, k = _shapes(config)
    dense = lambda width: 60 * t * width * c * c
    convs = (t * f * 3 * c + dense(f) + t * f2 * c * c * 3      # encoder
             + 2 * (dense(f2) + t * f2 * c * 2 * c * 3)          # decoders
             + t * f * c * 2 + t * f + t * f * c * 2 * 2)
    tokens = t * f2
    conformer = tokens * (16 * c * c + 4 * c * c + 6 * c * c + 2 * c * k)
    attn = 3 * d * attn_pairs(config, t)
    macs = convs + 2 * blocks * conformer + attn
    return {"total": 2.0 * macs, "attn": 2.0 * attn}


def pass_work(config: dict, lengths: Sequence[int], batch: int,
              operand_bytes: int = 2) -> Dict[str, float]:
    """FLOPs of a pass over utterances of `lengths` (samples), its
    attention's FLOPs and bytes, batched `batch` at a time."""
    f, f2, c, h, d, blocks, _ = _shapes(config)
    ts = [frames(config, n) for n in lengths]
    work = [utterance_flops(config, t) for t in ts]
    calls = 2 * blocks * math.ceil(len(lengths) / batch)
    emb = (2 * config["model"]["max_pos_emb"] + 1) * d
    moved = sum(4 * blocks * h * d * (f2 * t + t * f2) for t in ts)
    return {"flops": sum(w["total"] for w in work),
            "attn_flops": sum(w["attn"] for w in work),
            "attn_bytes": operand_bytes * (moved + calls * emb)}
