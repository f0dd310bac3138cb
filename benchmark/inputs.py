"""Everything a run feeds both the program and the reference, made from
the run's seed: weights, audio pools, segment cuts and latent draws.

The same seed gives the same inputs. Seeds may exceed 32 bits: each
stream of randomness takes its own 63-bit seed from a numpy
SeedSequence of (seed, purpose).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Sequence

import numpy as np
import torch


def subseed(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose of a run seeded with `seed`."""
    words = [int(seed) & (2**64 - 1)] + [
        zlib.crc32(str(p).encode()) for p in purpose]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def make_weights(layouts: Sequence[List[tuple]], seed: int,
                 device) -> List[Dict[str, torch.Tensor]]:
    """State dicts for `layouts` ((name, shape, init) lists), float32 on
    `device`, drawn there from one generator in two calls: uniform leaves
    in (-1/sqrt(fan_in), 1/sqrt(fan_in)) or, for ("range", lo, hi), in
    (lo, hi); the BN's gamma_ri from N(0, 1); the rest constants."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    leaves = [leaf for layout in layouts for leaf in layout]
    numel = lambda *kinds: sum(math.prod(s) for _, s, i in leaves
                               if i[0] in kinds)
    drawn = {"uniform": torch.rand(numel("uniform", "range"), generator=gen,
                                   device=device),
             "normal": torch.randn(numel("normal"), generator=gen,
                                   device=device)}
    pos = {"uniform": 0, "normal": 0}
    out = []
    for layout in layouts:
        sd = {}
        for name, shape, init in layout:
            if init[0] == "const":
                sd[name] = torch.full(shape, init[1], device=device)
                continue
            kind = "normal" if init[0] == "normal" else "uniform"
            n = math.prod(shape)
            t = drawn[kind][pos[kind]: pos[kind] + n].view(shape)
            pos[kind] += n
            if init[0] == "uniform":
                bound = 1.0 / math.sqrt(init[1])
                t = t * (2 * bound) - bound
            elif init[0] == "range":
                t = init[1] + t * (init[2] - init[1])
            sd[name] = t.clone()
        out.append(sd)
    return out


def speechlike(rng: np.random.Generator, n: int, fs: int) -> np.ndarray:
    """n samples of noise under a syllable-rate envelope (3-6 Hz) at a
    level drawn log-uniform in [-34, -14] dBFS: the energy contour of
    speech, which a random-weight model cannot tell from speech."""
    t = np.arange(n) / fs
    rate = rng.uniform(3.0, 6.0)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rate * t + rng.uniform(0, 6.3))
    gain = 10 ** (rng.uniform(-34.0, -14.0) / 20)
    return (gain * env * rng.standard_normal(n)).astype(np.float32)


def utterance_pool(mix: dict, seed: int, fs: int) -> List[np.ndarray]:
    """The eval mix's utterances, each length distinct so that sorting by
    length has one order: groups of `count` utterances of exactly
    `seconds` less i samples, or of lengths log-uniform in [min_s,
    max_s]."""
    rng = np.random.default_rng(subseed(seed, "pool"))
    lengths = []
    for group in mix["pool"]:
        if "seconds" in group:
            lengths += [int(group["seconds"] * fs) - i
                        for i in range(group["count"])]
        else:
            lo, hi = math.log(group["min_s"]), math.log(group["max_s"])
            lengths += [int(math.exp(rng.uniform(lo, hi)) * fs)
                        for _ in range(group["count"])]
    seen = set()
    for i, n in enumerate(lengths):
        while n in seen:
            n += 1
        seen.add(n)
        lengths[i] = n
    return [speechlike(rng, n, fs) for n in lengths]


def segment_pool(mix: dict, seed: int, fs: int) -> np.ndarray:
    """(utterances, samples) host pool that training segments are cut
    from."""
    rng = np.random.default_rng(subseed(seed, "segments"))
    n = int(mix["pool_seconds"] * fs)
    return np.stack([speechlike(rng, n, fs)
                     for _ in range(mix["pool_utterances"])])


def segment_cuts(pool: np.ndarray, batch: int, length: int, seed: int,
                 step: int) -> np.ndarray:
    """(batch, 2) distinct (utterance, offset) cuts of step `step`."""
    rng = np.random.default_rng(subseed(seed, "cuts", step))
    utts = rng.choice(pool.shape[0], size=batch, replace=batch > pool.shape[0])
    offs = rng.integers(0, pool.shape[1] - length + 1, size=batch)
    return np.stack([utts, offs], axis=1)


def cut(pool: np.ndarray, cuts: np.ndarray, length: int) -> np.ndarray:
    return np.stack([pool[u, o: o + length] for u, o in cuts])


def latent_draws(shape, seed: int, step: int, device):
    """(eps_r, eps_i) of one step, each `shape`, on `device`."""
    gen = torch.Generator(device=device).manual_seed(
        subseed(seed, "draws", step))
    return tuple(torch.randn(shape, generator=gen, device=device)
                 for _ in range(2))


def stream_audio(seconds: float, seed: int, fs: int) -> np.ndarray:
    """(1, samples) of one stream."""
    rng = np.random.default_rng(subseed(seed, "stream"))
    return speechlike(rng, int(seconds * fs), fs)[None]
