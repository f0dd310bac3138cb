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

Threads: importing this module caps torch's intra-op threads at the
cores per pytest-xdist worker (`TORCH_THREADS`), and `subprocess_env`
gives a subprocess the same cap. Left at its default, every worker runs
torch with one thread per core, and under `-n 6` the workers' thread
pools oversubscribe the cores many times over (a 27 s test then takes
minutes).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from idccrn_vae_tpu.models.config import DccrnConfig as JaxConfig
from idccrn_vae_torch.models.config import DccrnConfig as TorchConfig

TORCH_THREADS = max(1, (os.cpu_count() or 1)
                    // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(TORCH_THREADS)


def subprocess_env(**extra) -> dict:
    """The environment of a subprocess a port test starts: this process's,
    with OpenMP's and MKL's thread counts at TORCH_THREADS, plus `extra`."""
    threads = str(TORCH_THREADS)
    return {**os.environ, "OMP_NUM_THREADS": threads,
            "MKL_NUM_THREADS": threads, **extra}


TINY = dict(encoder_channels=(1, 2, 2, 4, 4, 4, 4), zdim=4, num_samples=1)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# a parameter's delta after one SGD step (tests/test_oracle_train_step.py)
GRAD_TOL = dict(atol=5e-6, rtol=5e-3)
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


class FixedNoise:
    """The same draws for every call of one shape: a JAX step that runs
    its encoder twice in one trace (phase 2's D-update batches) and the
    port's single pass then see the same latent samples."""

    def __init__(self, seed: int = 123):
        self.seed = seed
        self.draws = {}

    def __call__(self, b: int, s: int, t: int, h: int):
        key = (b, s, t, h)
        if key not in self.draws:
            self.draws[key] = NoiseStream(self.seed)(b, s, t, h)
        return self.draws[key]


# ------------------------------------------------------------ train steps


def state_dict_of(variables, prefix=""):
    """JAX variables -> a port state_dict of torch tensors."""
    from idccrn_vae_torch.models.from_jax import jax_to_state_dict

    return {k: torch.from_numpy(v) for k, v in
            jax_to_state_dict(np_vars(variables), prefix).items()}


def check_models(port, before, jax_after, what, prefix=""):
    """Parameter deltas (GRAD_TOL), buffers (F32_TOL) and BN counters of
    a port module after a step, against the JAX variables after it;
    `before` is the common starting state_dict, `prefix` the module's
    state_dict prefix (a supervised DCCRN's). Returns the largest
    |delta|."""
    from idccrn_vae_torch.models.from_jax import jax_bn_counts
    from idccrn_vae_torch.models.modules import ComplexBatchNorm

    want = state_dict_of(jax_after, prefix)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    names = {n for n, _ in port.named_parameters()}
    moved = 0.0
    for k in want:
        want[k] = want[k].reshape(got[k].shape)
        if k in names:
            d_got, d_want = got[k] - before[k], want[k] - before[k]
            np.testing.assert_allclose(d_got.numpy(), d_want.numpy(),
                                       err_msg=f"{what} delta {k}",
                                       **GRAD_TOL)
            moved = max(moved, float(d_want.abs().max()))
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=f"{what} {k}", **F32_TOL)
    counts = jax_bn_counts(np_vars(jax_after), prefix)
    for name, m in port.named_modules():
        if isinstance(m, ComplexBatchNorm):
            assert int(m.count) == counts[name], (what, name)
    return moved


def value_and_grads(fn_j, fn_t, inputs, seed=0):
    """Run fn_j (dict of jnp arrays -> tuple of outputs) and fn_t (dict
    of torch tensors -> tuple of outputs) on the same inputs; compare
    every output (F32_TOL) and the gradient of one fixed random
    contraction of the outputs with respect to every input (GRAD_TOL).
    Returns the port's gradients."""
    rng = np.random.default_rng(seed)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    outs_j = fn_j(jin)
    ws = [rng.standard_normal(np.shape(o)).astype(np.float32)
          for o in outs_j]
    grads_j = jax.grad(lambda d: sum(jnp.sum(o * w)
                                     for o, w in zip(fn_j(d), ws)))(jin)
    tin = {k: torch.tensor(v, requires_grad=True) for k, v in inputs.items()}
    outs_t = fn_t(tin)
    assert len(outs_t) == len(outs_j)
    for i, (ot, oj) in enumerate(zip(outs_t, outs_j)):
        assert_close(ot, oj)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs_t, ws)
        ).backward()
    grads = {}
    for k, t in tin.items():
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(to_np(g), to_np(grads_j[k]),
                                   err_msg=f"grad {k}", **GRAD_TOL)
        grads[k] = g
    return grads


def check_metrics(got, want, tol=F32_TOL):
    """The same metric keys, each value within `tol`."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **tol)


def datanorm_stats(seed: int, freq_bins: int = 257):
    """Per-bin (mean, std), each (F, 2) float32, std > 0."""
    rng = np.random.default_rng(seed)
    mean = 0.01 * rng.standard_normal((freq_bins, 2))
    std = 1.0 + 0.1 * rng.random((freq_bins, 2))
    return mean.astype(np.float32), std.astype(np.float32)


def wav_batch(seed: int, b: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((b, n))).astype(np.float32)


# ------------------------------------------ pretrain, NSVAE, supervised

TRAIN_LR = 1e-2
TRAIN_B, TRAIN_L = 3, 800


def train_wav(seed, n=TRAIN_B):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (n, TRAIN_L))).astype(np.float32)


def pretrain_pair(monkeypatch, sgd=True, warm=False, datanorm=False,
                  **cfg_kw):
    """(JAX trainer, JAX state, port trainer) of CVAE pretraining from the
    same weights, tiny geometry, num_samples 2; `datanorm` gives both a
    per-bin (mean, std); `warm` takes one JAX step first (the BN
    counters are 1 when the port loads) and starts fresh optimizers."""
    import optax

    from idccrn_vae_tpu.losses.vae_loss import PretrainVaeLoss as JVaeLoss
    from idccrn_vae_tpu.train.pretrain import (
        PretrainTrainer as JPretrainTrainer,
    )
    from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
    from idccrn_vae_torch.models.from_jax import load_jax_variables
    from idccrn_vae_torch.train.pretrain import PretrainTrainer

    lr = TRAIN_LR
    jc, tc = configs(stft=TINY_STFT, num_samples=2, **cfg_kw)
    kw = dict(kl_weight=0.05, mi_weight=0.2, num_samples=2,
              recon_loss_weight=(1.0, 0.5, 0.1))
    warm_w = np.asarray([0.1, 0.5], np.float32)
    dn = datanorm_stats(8, TINY_STFT["n_fft"] // 2 + 1) if datanorm else None
    jtr = JPretrainTrainer(jc, JVaeLoss(warm_w, **kw), lr, datanorm=dn)
    if sgd:
        jtr.tx_en = jtr.tx_de = optax.sgd(lr)
    state = jtr.init_state()
    if warm:
        patch_jax_noise(monkeypatch, NoiseStream(9),
                        module="idccrn_vae_tpu.models.vae")
        state, _ = jtr.train_step(state, train_wav(50, 5),
                                  jax.random.PRNGKey(5), 0)
        state["opt_en"] = jtr.tx_en.init(state["enc"]["params"])
        state["opt_de"] = jtr.tx_de.init(state["dec"]["params"])
    ttr = PretrainTrainer(tc, PretrainVaeLoss(warm_w, **kw), lr,
                          datanorm=dn, device="cpu")
    load_jax_variables(ttr.encoder, np_vars(state["enc"]))
    load_jax_variables(ttr.decoder, np_vars(state["dec"]))
    if sgd:
        ttr.opt_en = torch.optim.SGD(ttr.encoder.parameters(), lr=lr)
        ttr.opt_de = torch.optim.SGD(ttr.decoder.parameters(), lr=lr)
    return jtr, state, ttr


def nsvae_pair(trainable=None, sgd=True, **cfg_kw):
    """(JAX trainer, JAX state, port trainer) of NSVAE posterior
    matching: latent_num 2, original channels, matching 'both', from the
    same weights."""
    import optax

    from idccrn_vae_tpu.losses.nsvae_loss import (
        NsvaeTrueKlLoss as JNsvaeLoss,
    )
    from idccrn_vae_tpu.train.nsvae import NsvaeTrainer as JNsvaeTrainer
    from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
    from idccrn_vae_torch.models.from_jax import load_jax_variables
    from idccrn_vae_torch.train.nsvae import NsvaeTrainer

    lr = TRAIN_LR
    jpre, tpre = configs(stft=TINY_STFT, **cfg_kw)
    jnoisy, tnoisy = configs(stft=TINY_STFT, latent_num=2, **cfg_kw)
    kw = dict(alpha=0.8, w_resi=0.3, w_kl=1.0, w_dismiu=0.5,
              matching="both")
    jtr = JNsvaeTrainer(jpre, jnoisy, JNsvaeLoss(cfg=jnoisy, **kw), lr,
                        trainable=trainable)
    if sgd:
        jtr.tx = optax.sgd(lr)
    state = jtr.init_state()
    ttr = NsvaeTrainer(tpre, tnoisy, NsvaeTrueKlLoss(cfg=tnoisy, **kw), lr,
                       trainable=trainable, device="cpu")
    for name, m in ttr.models.items():
        load_jax_variables(m, np_vars(state["models"][name]))
    if sgd:
        params = [p for m in ttr.models.values() for p in m.parameters()
                  if p.requires_grad]
        ttr.opt = torch.optim.SGD(params, lr=lr)
    return jtr, state, ttr


def supervised_pair(datanorm, **cfg_kw):
    """(JAX trainer, JAX state, port trainer) of the supervised DCCRN with
    SGD, from the same weights: the supervised_dccrn.ini usage line
    (causal, mask, real skips) at tiny geometry."""
    import optax

    from idccrn_vae_tpu.losses.phase2 import EteTrainSeLoss as JLoss
    from idccrn_vae_tpu.train.supervised import (
        SupervisedTrainer as JTrainer,
    )
    from idccrn_vae_torch.losses.phase2 import EteTrainSeLoss
    from idccrn_vae_torch.models.from_jax import load_jax_variables
    from idccrn_vae_torch.train.supervised import SupervisedTrainer

    lr = TRAIN_LR
    jc, tc = configs(stft=TINY_STFT, causal=True, recon_type="mask",
                     skip_mode="real", lstm_hidden=8, **cfg_kw)
    dn = datanorm_stats(3, TINY_STFT["n_fft"] // 2 + 1) if datanorm else None
    weights = (1.0, 1.0, 0.5)
    jtr = JTrainer(jc, JLoss(weights), lr, datanorm=dn)
    jtr.tx = optax.sgd(lr)
    state = jtr.init_state()
    ttr = SupervisedTrainer(tc, EteTrainSeLoss(weights), lr, datanorm=dn,
                            device="cpu")
    load_jax_variables(ttr.model, np_vars(state["model"]))
    ttr.opt = torch.optim.SGD(ttr.model.parameters(), lr=lr)
    return jtr, state, ttr


# ------------------------------------------------------- phase-2 trainers

PHASE2_LR = 1e-2
PHASE2_B, PHASE2_L = 3, 800
_PHASE2_JAX = {}


def phase2_wav(seed, n=PHASE2_B):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (n, PHASE2_L))).astype(np.float32)


def phase2_batch(seed):
    """(noisy, clean, noise) waveforms of a phase-2 training batch."""
    return tuple(phase2_wav(seed + k) for k in range(3))


def clone_state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def phase2_pair(monkeypatch, sgd=True, adversarial=False, d_step=1,
                decode_update="all_decode", latent_num=1, enc_kw=None,
                dec_kw=None):
    """(JAX trainer, JAX state, port trainer) of phase 2 from the same
    weights, tiny geometry; the encoder's latent draws patched on both
    sides (`FixedNoise`). JAX trainers that differ only in d_step are one
    object (d_step is read outside its jitted step), so the d_step cases
    share its compiled programs."""
    import optax

    from idccrn_vae_tpu.losses import phase2 as jloss
    from idccrn_vae_tpu.train.phase2 import Phase2Trainer as JPhase2Trainer
    from idccrn_vae_torch.losses import phase2 as tloss
    from idccrn_vae_torch.models.from_jax import load_jax_variables
    from idccrn_vae_torch.train.phase2 import (
        Phase2Trainer,
        trained_parameters,
    )

    lr = PHASE2_LR
    enc_kw = dict(latent_num=latent_num, **(enc_kw or {}))
    dec_kw = dict(latent_num=latent_num, skip_mode="runtime",
                  recon_type="mask", **(dec_kw or {}))
    jenc, tenc = configs(stft=TINY_STFT, **enc_kw)
    jdec, tdec = configs(stft=TINY_STFT, **dec_kw)
    kw = dict(recon_loss_weight=(1.0, 0.5, 0.2), alpha=1.0,
              latent_num=latent_num)
    trainer_kw = dict(adversarial=adversarial, dis_lr=2 * lr, d_step=d_step,
                      decode_update=decode_update)
    key = repr((sgd, enc_kw, dec_kw, adversarial, decode_update))
    if key not in _PHASE2_JAX:
        jtr = JPhase2Trainer(jenc, jdec, jloss.TwoPhaseLoss(**kw), lr,
                             **trainer_kw)
        if sgd:
            jtr.tx = optax.sgd(lr)
            jtr.tx_dis = optax.sgd(2 * lr) if adversarial else None
        _PHASE2_JAX[key] = (jtr, jtr.init_state())
    jtr, state = _PHASE2_JAX[key]
    jtr.d_step, jtr._batch_counter = d_step, 0
    ttr = Phase2Trainer(tenc, tdec, tloss.TwoPhaseLoss(**kw), lr,
                        device="cpu", **trainer_kw)
    assert sorted(ttr.models) == sorted(state["models"])
    for name, m in ttr.models.items():
        load_jax_variables(m, np_vars(state["models"][name]))
    if sgd:
        ttr.opt = torch.optim.SGD(
            [p for d in ttr.decoders.values()
             for p in trained_parameters(d, decode_update)], lr=lr)
        if adversarial:
            ttr.opt_dis = torch.optim.SGD(ttr.dis.parameters(), lr=2 * lr)
    noise = FixedNoise(5)
    patch_jax_noise(monkeypatch, noise)
    patch_port_noise(monkeypatch, noise)
    return jtr, state, ttr


# ------------------------------------------------------- training CLIs


def train_ini(path, saved_root, model_name, user, epochs=2):
    """A tiny ini in the layout of configs/*.ini: 17-frame windows of
    1600 samples at the reference STFT, batches of 2, `epochs` epochs,
    a checkpoint every epoch."""
    lines = ["[User]", "logger_type = 1", f"saved_root = {saved_root}",
             f"model_name = {model_name}"]
    lines += [f"{k} = {v}" for k, v in user.items()]
    lines += ["", "[STFT]", "winlen = 400", "nfft = 512", "hopfrac = 100",
              "fs = 16000", "trim = False", "",
              "[Network]", "z_dim = 4", "clean_encoder = False",
              "noise_encoder = False", "",
              "[Training]", "optimization = adam", "lr = 1e-3",
              f"epochs = {epochs}", "early_stop_patience = 5",
              "save_frequency = 1", "",
              "[DataFrame]", f"dataset_name = {model_name}", "suffix = wav",
              "num_workers = 1", "batch_size = 2", "shuffle = True",
              "sequence_len = 17", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return str(path)


def run_dir(saved_root):
    """The one run directory a training CLI made under `saved_root`."""
    import os

    (name,) = os.listdir(saved_root)
    return os.path.join(saved_root, name)


def finite_curves(curves, epochs):
    """`epochs` rows of train and val metrics, every value finite."""
    import math

    assert len(curves["train"]) == len(curves["val"]) == epochs
    for split in ("train", "val"):
        for row in curves[split]:
            assert row and all(math.isfinite(v) for v in row.values()), row


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
