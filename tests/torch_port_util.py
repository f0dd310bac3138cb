"""Shared helpers for the port's parity tests (tests/test_torch_port_*.py).

Both sides get the same inputs, made from a seed with numpy, and the
same weights: JAX variables from `.init`, loaded into the port through
`load_jax_variables`.

Tolerances:
  * f32: atol 1e-4 and rtol 1e-4, the reference oracles' tolerance
    (tests/oracle_ref.py).
  * bf16: max |port - jax| <= BF16_REL * max |jax|. The two frameworks
    round at different points inside a bf16 conv (accumulation order,
    when the f32 accumulator is rounded), so single elements may differ
    by a bf16 ulp (2**-8 relative) at each stage; across the network
    that stays well under 2% of the output's range.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from idccrn_vae_tpu.models.config import DccrnConfig as JaxConfig
from idccrn_vae_torch.models.config import DccrnConfig as TorchConfig

TINY = dict(encoder_channels=(1, 2, 2, 4, 4, 4, 4), zdim=4, num_samples=1)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 2e-2


def configs(**overrides):
    """(JAX config, port config) with the same fields, tiny geometry.

    stft: optional dict of StftConfig fields (e.g. TINY_STFT), built
    into each side's own StftConfig."""
    fields = dict(TINY, **overrides)
    stft = fields.pop("stft", None)
    if stft is None:
        return JaxConfig(**fields), TorchConfig(**fields)
    from idccrn_vae_tpu.models.config import StftConfig as JaxStft
    from idccrn_vae_torch.models.config import StftConfig as TorchStft

    return (JaxConfig(stft=JaxStft(**stft), **fields),
            TorchConfig(stft=TorchStft(**stft), **fields))


# n_fft 32: 17 frequency bins, 1 at the bottleneck of the 6 stages
TINY_STFT = dict(n_fft=32, hop=8, win_length=16)


def np_vars(variables):
    """JAX variable tree -> numpy leaves."""
    return jax.tree.map(np.asarray, variables)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(port, ref, compute: str = "f32") -> None:
    port, ref = to_np(port), to_np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.isfinite(port).all()
    if compute == "f32":
        np.testing.assert_allclose(port, ref, **F32_TOL)
    else:
        err = np.abs(port - ref).max()
        scale = np.abs(ref).max()
        assert err <= BF16_REL * scale, (err, scale)


class NoiseStream:
    """Identical latent draws for both sides, in call order.

    Each call returns (eps_r, eps_i) of the shape the caller needs,
    from a numpy generator with a fixed seed; two streams with the same
    seed hand out the same draws to the JAX and the port side.
    """

    def __init__(self, seed: int = 123):
        self.rng = np.random.default_rng(seed)

    def __call__(self, b: int, s: int, t: int, h: int):
        return tuple(self.rng.standard_normal((b, s, t, h)).astype(np.float32)
                     for _ in range(2))


def patch_jax_noise(monkeypatch, stream: NoiseStream,
                    module: str = "idccrn_vae_tpu.models.nsvae") -> None:
    """Route the draws of the JAX encoder in `module` (the NSVAE encoder
    by default) through `stream` (test-side patch of the name the
    encoder module looks up)."""
    from idccrn_vae_tpu.models.reparam import reparameterize

    def fixed(rng, g, num_samples, guard="eps", noise=None):
        b, t, h = g.mu_r.shape
        er, ei = stream(b, num_samples, t, h)
        return reparameterize(rng, g, num_samples, guard=guard,
                              noise=(jnp.asarray(er), jnp.asarray(ei)))

    monkeypatch.setattr(f"{module}.reparameterize", fixed)


def patch_port_noise(monkeypatch, stream: NoiseStream,
                     module: str = "idccrn_vae_torch.models.nsvae") -> None:
    """Route the draws of the port encoder in `module` (the NSVAE
    encoder by default, `idccrn_vae_torch.models.vae` for the VAE
    encoder) through `stream`."""
    from idccrn_vae_torch.models.reparam import reparameterize

    def fixed(g, num_samples, guard="eps", noise=None, generator=None):
        b, t, h = g.mu_r.shape
        er, ei = stream(b, num_samples, t, h)
        return reparameterize(g, num_samples, guard=guard,
                              noise=(torch.from_numpy(er),
                                     torch.from_numpy(ei)))

    monkeypatch.setattr(f"{module}.reparameterize", fixed)


def datanorm_stats(seed: int, freq_bins: int = 257):
    """Per-bin (mean, std), each (F, 2) float32, std > 0."""
    rng = np.random.default_rng(seed)
    mean = 0.01 * rng.standard_normal((freq_bins, 2))
    std = 1.0 + 0.1 * rng.random((freq_bins, 2))
    return mean.astype(np.float32), std.astype(np.float32)


def wav_batch(seed: int, b: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((b, n))).astype(np.float32)


# ------------------------------------------------- evaluation entry points

FS = 16000
PCM16_LSB = 1.0 / 32768


def write_test_set(root, lengths, seed: int = 0, fs: int = FS):
    """Speech-like clean/noisy pairs of the given lengths (samples) under
    root/clean and root/noisy (DNS '*_fileid_<i>' names), and a
    corpus_meta.json giving utterance i the SNR bucket i % 4.

    Returns (noisy_paths, clean_paths, meta_path)."""
    import json
    import os

    from idccrn_vae_tpu.data.audio_io import write_wav
    from idccrn_vae_tpu.data.synth import (
        SNR_BUCKETS,
        bucket_label,
        mix_at_snr,
        synth_noise,
        synth_speech,
    )

    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(str(root), k) for k in ("clean", "noisy")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    meta = {"buckets": [bucket_label(*b) for b in SNR_BUCKETS], "files": {}}
    noisy_paths, clean_paths = [], []
    for i, n in enumerate(lengths):
        lo, hi = SNR_BUCKETS[i % len(SNR_BUCKETS)]
        clean = synth_speech(rng, n, fs)
        noisy, _ = mix_at_snr(clean, synth_noise(rng, n, fs)[0],
                              float(rng.uniform(lo, hi)))
        noisy_paths.append(os.path.join(dirs["noisy"],
                                        f"noisy_fileid_{i}.wav"))
        clean_paths.append(os.path.join(dirs["clean"],
                                        f"clean_fileid_{i}.wav"))
        write_wav(noisy_paths[-1], noisy, fs)
        write_wav(clean_paths[-1], clean, fs)
        meta["files"][f"val/noisy_fileid_{i}.wav"] = {
            "bucket": bucket_label(lo, hi)}
    meta_path = os.path.join(str(root), "corpus_meta.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return noisy_paths, clean_paths, meta_path


def assert_json_close(got, want, atol: float, path: str = "") -> None:
    """Same structure and strings; numbers within atol (None == None)."""
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_json_close(got[k], want[k], atol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, atol, f"{path}/{i}")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert abs(float(got) - float(want)) <= atol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def read_json(*parts):
    import json
    import os

    with open(os.path.join(*parts)) as f:
        return json.load(f)


def assert_wavs_within_lsb(dir_got: str, dir_want: str, names) -> None:
    """The same files in both dirs, 16 kHz, equal lengths, samples within
    one PCM16 step (the two sides' float outputs may round to
    neighbouring codes)."""
    import os

    from idccrn_vae_tpu.data.audio_io import read_wav

    assert sorted(os.listdir(dir_got)) == sorted(names)
    for name in names:
        got, fs_g = read_wav(os.path.join(dir_got, name))
        want, fs_w = read_wav(os.path.join(dir_want, name))
        assert fs_g == fs_w == FS and got.shape == want.shape, name
        assert np.abs(got - want).max() <= PCM16_LSB, name
