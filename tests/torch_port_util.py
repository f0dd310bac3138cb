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
# DccrnConfig()'s widths (channels 1-32-64-128-128-256-256, zdim 128, LSTM
# hidden 128) and each side's default StftConfig (n_fft 512: 257 bins)
REFERENCE = dict(num_samples=1)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# a parameter's delta after one SGD step (tests/test_oracle_train_step.py)
GRAD_TOL = dict(atol=5e-6, rtol=5e-3)
BF16_REL = 2e-2


def configs(geometry="tiny", **overrides):
    """(JAX config, port config) with the same fields, at `geometry`:
    "tiny" (TINY) or "reference" (DccrnConfig()'s widths).

    stft: optional dict of StftConfig fields (e.g. TINY_STFT), built
    into each side's own StftConfig."""
    fields = dict(TINY if geometry == "tiny" else REFERENCE, **overrides)
    stft = fields.pop("stft", None)
    if stft is None:
        return JaxConfig(**fields), TorchConfig(**fields)
    from idccrn_vae_tpu.models.config import StftConfig as JaxStft
    from idccrn_vae_torch.models.config import StftConfig as TorchStft

    return (JaxConfig(stft=JaxStft(**stft), **fields),
            TorchConfig(stft=TorchStft(**stft), **fields))


# n_fft 32: 17 frequency bins, 1 at the bottleneck of the 6 stages
TINY_STFT = dict(n_fft=32, hop=8, win_length=16)


def geo_configs(geometry="tiny", **fields):
    """`configs` of a trainer helper: the tiny geometry with TINY_STFT,
    or the reference geometry with each side's default STFT."""
    if geometry == "tiny":
        return configs(stft=TINY_STFT, **fields)
    assert geometry == "reference", geometry
    return configs("reference", **fields)


def freq_bins(geometry="tiny") -> int:
    """The STFT's frequency bins at `geometry` (a datanorm's rows)."""
    n_fft = TINY_STFT["n_fft"] if geometry == "tiny" else 512
    return n_fft // 2 + 1


def init_key(seed):
    """A JAX trainer's `init_state` key: its own default when seed is
    None, else PRNGKey(seed)."""
    return None if seed is None else jax.random.PRNGKey(seed)


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


def f32_param_bound(kappa=None, even=None) -> float:
    """A parameter update's f32 bound in relative L2: GRAD_TOL's rtol,
    times max(1, SPREAD_K * kappa, SPREAD_K * even): kappa, for a PReLU
    slope, whose gradient is one cancelling sum, the L2 norm of the sum's
    terms over the sum (`SlopeTerms`; each term within rtol, their errors
    independent); even, the parameter's `even_share` of a model update
    held to rtol (an update near zero by the model's structure, a last
    stage's BN gamma_ri, has only its share of the model's error)."""
    return GRAD_TOL["rtol"] * max(1.0, SPREAD_K * (kappa or 0.0),
                                  SPREAD_K * (even or 0.0))


def check_models_l2(port, before, jax_after, what, prefix="", kappa=None):
    """`check_models` at the reference geometry: each parameter's update
    within `f32_param_bound` in relative L2 (a BN-fed conv bias, whose
    update is rounding, by its share of the model's update, within
    GRAD_TOL's rtol), buffers at F32_TOL, BN counters equal. Element by
    element GRAD_TOL holds the JAX package to less than its own f32
    reproducibility at this geometry (tests/test_torch_port_fullwidth.py).
    kappa: {param: its slope's kappa}. Returns {param: relative L2 over
    its bound}."""
    from idccrn_vae_torch.models.from_jax import jax_bn_counts
    from idccrn_vae_torch.models.modules import ComplexBatchNorm

    want = state_dict_of(jax_after, prefix)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    names = [n for n, _ in port.named_parameters()]
    d_got = {k: (got[k] - before[k]).double() for k in names}
    d_want = {k: (want[k].reshape(got[k].shape) - before[k]).double()
              for k in names}
    flat = torch.cat([d.flatten() for d in d_want.values()])
    whole = flat.norm()
    rel = {}
    for k in names:
        if bn_fed_bias(k):
            share = float((d_got[k] - d_want[k]).norm() / whole)
            assert share <= GRAD_TOL["rtol"], (what, k, share)
            continue
        even = even_share(d_want[k].numel(), flat.numel(),
                          float(d_want[k].norm() / whole))
        rel[k] = rel_dist(d_got[k], d_want[k]) / f32_param_bound(
            (kappa or {}).get(k), even)
        assert rel[k] <= 1, (what, k, rel[k])
    for k in want:
        if k not in d_got:
            np.testing.assert_allclose(got[k].numpy(),
                                       want[k].reshape(got[k].shape).numpy(),
                                       err_msg=f"{what} {k}", **F32_TOL)
    counts = jax_bn_counts(np_vars(jax_after), prefix)
    for name, m in port.named_modules():
        if isinstance(m, ComplexBatchNorm):
            assert int(m.count) == counts[name], (what, name)
    return rel


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
# a reference-geometry step's segment: 0.5 s, 81 frames of the default STFT
REFERENCE_L = 8000
STEP_LEN = {"tiny": TRAIN_L, "reference": REFERENCE_L}


def train_wav(seed, n=TRAIN_B, length=TRAIN_L):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (n, length))).astype(np.float32)


def pretrain_pair(monkeypatch, sgd=True, warm=False, datanorm=False,
                  geometry="tiny", seed=None, **cfg_kw):
    """(JAX trainer, JAX state, port trainer) of CVAE pretraining from the
    same weights, at `geometry`, num_samples 2; `datanorm` gives both a
    per-bin (mean, std); `warm` takes one JAX step first (the BN
    counters are 1 when the port loads) and starts fresh optimizers;
    `seed` picks the JAX init (default: the trainer's own)."""
    import optax

    from idccrn_vae_tpu.losses.vae_loss import PretrainVaeLoss as JVaeLoss
    from idccrn_vae_tpu.train.pretrain import (
        PretrainTrainer as JPretrainTrainer,
    )
    from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
    from idccrn_vae_torch.models.from_jax import load_jax_variables
    from idccrn_vae_torch.train.pretrain import PretrainTrainer

    lr = TRAIN_LR
    jc, tc = geo_configs(geometry, num_samples=2, **cfg_kw)
    kw = dict(kl_weight=0.05, mi_weight=0.2, num_samples=2,
              recon_loss_weight=(1.0, 0.5, 0.1))
    warm_w = np.asarray([0.1, 0.5], np.float32)
    dn = datanorm_stats(8, freq_bins(geometry)) if datanorm else None
    jtr = JPretrainTrainer(jc, JVaeLoss(warm_w, **kw), lr, datanorm=dn)
    if sgd:
        jtr.tx_en = jtr.tx_de = optax.sgd(lr)
    state = jtr.init_state(init_key(seed))
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


def nsvae_pair(trainable=None, sgd=True, geometry="tiny", seed=None,
               **cfg_kw):
    """(JAX trainer, JAX state, port trainer) of NSVAE posterior
    matching: latent_num 2, original channels, matching 'both', from the
    same weights, at `geometry`; `seed` picks the JAX init."""
    import optax

    from idccrn_vae_tpu.losses.nsvae_loss import (
        NsvaeTrueKlLoss as JNsvaeLoss,
    )
    from idccrn_vae_tpu.train.nsvae import NsvaeTrainer as JNsvaeTrainer
    from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
    from idccrn_vae_torch.models.from_jax import load_jax_variables
    from idccrn_vae_torch.train.nsvae import NsvaeTrainer

    lr = TRAIN_LR
    jpre, tpre = geo_configs(geometry, **cfg_kw)
    jnoisy, tnoisy = geo_configs(geometry, latent_num=2, **cfg_kw)
    kw = dict(alpha=0.8, w_resi=0.3, w_kl=1.0, w_dismiu=0.5,
              matching="both")
    jtr = JNsvaeTrainer(jpre, jnoisy, JNsvaeLoss(cfg=jnoisy, **kw), lr,
                        trainable=trainable)
    if sgd:
        jtr.tx = optax.sgd(lr)
    state = jtr.init_state(init_key(seed))
    ttr = NsvaeTrainer(tpre, tnoisy, NsvaeTrueKlLoss(cfg=tnoisy, **kw), lr,
                       trainable=trainable, device="cpu")
    for name, m in ttr.models.items():
        load_jax_variables(m, np_vars(state["models"][name]))
    if sgd:
        params = [p for m in ttr.models.values() for p in m.parameters()
                  if p.requires_grad]
        ttr.opt = torch.optim.SGD(params, lr=lr)
    return jtr, state, ttr


def supervised_pair(datanorm, geometry="tiny", seed=None, **cfg_kw):
    """(JAX trainer, JAX state, port trainer) of the supervised DCCRN with
    SGD, from the same weights: the supervised_dccrn.ini usage line
    (causal, mask, real skips) at `geometry` (tiny: LSTM hidden 8;
    reference: the ini's, DccrnConfig's 128); `seed` picks the JAX
    init."""
    import optax

    from idccrn_vae_tpu.losses.phase2 import EteTrainSeLoss as JLoss
    from idccrn_vae_tpu.train.supervised import (
        SupervisedTrainer as JTrainer,
    )
    from idccrn_vae_torch.losses.phase2 import EteTrainSeLoss
    from idccrn_vae_torch.models.from_jax import load_jax_variables
    from idccrn_vae_torch.train.supervised import SupervisedTrainer

    lr = TRAIN_LR
    if geometry == "tiny":
        cfg_kw = dict(lstm_hidden=8, **cfg_kw)
    jc, tc = geo_configs(geometry, causal=True, recon_type="mask",
                         skip_mode="real", **cfg_kw)
    dn = datanorm_stats(3, freq_bins(geometry)) if datanorm else None
    weights = (1.0, 1.0, 0.5)
    jtr = JTrainer(jc, JLoss(weights), lr, datanorm=dn)
    jtr.tx = optax.sgd(lr)
    state = jtr.init_state(init_key(seed))
    ttr = SupervisedTrainer(tc, EteTrainSeLoss(weights), lr, datanorm=dn,
                            device="cpu")
    load_jax_variables(ttr.model, np_vars(state["model"]))
    ttr.opt = torch.optim.SGD(ttr.model.parameters(), lr=lr)
    return jtr, state, ttr


# ------------------------------------------------------- phase-2 trainers

PHASE2_LR = 1e-2
PHASE2_B, PHASE2_L = 3, 800
_PHASE2_JAX = {}


def phase2_wav(seed, n=PHASE2_B, length=PHASE2_L):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (n, length))).astype(np.float32)


def phase2_batch(seed, n=PHASE2_B, length=PHASE2_L):
    """(noisy, clean, noise) waveforms of a phase-2 training batch."""
    return tuple(phase2_wav(seed + k, n, length) for k in range(3))


def clone_state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def phase2_pair(monkeypatch, sgd=True, adversarial=False, d_step=1,
                decode_update="all_decode", latent_num=1, enc_kw=None,
                dec_kw=None, geometry="tiny", seed=None):
    """(JAX trainer, JAX state, port trainer) of phase 2 from the same
    weights, at `geometry`; the encoder's latent draws patched on both
    sides (`FixedNoise`); `seed` picks the JAX init. JAX trainers that
    differ only in d_step are one object (d_step is read outside its
    jitted step), so the d_step cases share its compiled programs."""
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
    jenc, tenc = geo_configs(geometry, **enc_kw)
    jdec, tdec = geo_configs(geometry, **dec_kw)
    kw = dict(recon_loss_weight=(1.0, 0.5, 0.2), alpha=1.0,
              latent_num=latent_num)
    trainer_kw = dict(adversarial=adversarial, dis_lr=2 * lr, d_step=d_step,
                      decode_update=decode_update)
    key = repr((sgd, enc_kw, dec_kw, adversarial, decode_update, geometry,
                seed))
    if key not in _PHASE2_JAX:
        jtr = JPhase2Trainer(jenc, jdec, jloss.TwoPhaseLoss(**kw), lr,
                             **trainer_kw)
        if sgd:
            jtr.tx = optax.sgd(lr)
            jtr.tx_dis = optax.sgd(2 * lr) if adversarial else None
        _PHASE2_JAX[key] = (jtr, jtr.init_state(init_key(seed)))
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
    noise = FixedNoise(5 if seed is None else seed)
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


# ------------------------------------- one step of each of the trainers


class Recorder:
    """Wraps `randn_rows` and keeps what it drew, paired as the
    (eps_r, eps_i) of each reparameterization."""

    def __init__(self, fn):
        self.fn, self.draws = fn, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.draws.append(out.clone())
        return out

    def pairs(self):
        return list(zip(self.draws[0::2], self.draws[1::2]))


def patch_jax_draws(monkeypatch, pairs):
    """The JAX encoders' draws: the recorded pairs of each shape in
    order, the last one repeating (phase 2's JAX step encodes twice on a
    D-update batch, the port once)."""
    from idccrn_vae_tpu.models.reparam import reparameterize

    by_shape = {}
    for er, ei in pairs:
        by_shape.setdefault(tuple(er.shape), []).append(
            (jnp.asarray(er.numpy()), jnp.asarray(ei.numpy())))

    def fixed(rng, g, num_samples, guard="eps", noise=None):
        queue = by_shape[(*g.mu_r.shape[:1], num_samples,
                          *g.mu_r.shape[1:])]
        pair = queue.pop(0) if len(queue) > 1 else queue[0]
        return reparameterize(rng, g, num_samples, guard=guard, noise=pair)

    for module in ("vae", "nsvae"):
        monkeypatch.setattr(f"idccrn_vae_tpu.models.{module}.reparameterize",
                            fixed)


def _recipe(kind, ttr, args, kwargs, sgd, batch):
    import torch_port_ranks as ranks

    return dict(kind=kind, args=args, kwargs=kwargs, sgd=sgd, batch=batch,
                models=ranks.model_state(ttr), epoch=1, seed=7)


def step_cases(monkeypatch, b, geometry="tiny", **cfg_kw):
    """One SGD step of each of the four trainers, from the JAX trainers'
    initial weights, at a batch of `b` segments of STEP_LEN[geometry]
    samples, at `geometry`, with `cfg_kw` in every config:
    pretraining with the MI term (real skips), the NSVAE with its partial
    freeze, adversarial phase 2 at d_step 2 (its first step updates D),
    and the supervised DCCRN. Returns a list of (recipe for
    `torch_port_ranks`, JAX trainer, JAX state, model name -> its path in
    the JAX state). The port's encoders draw from their generators."""
    from idccrn_vae_torch.models import reparam

    out, length = [], STEP_LEN[geometry]
    jtr, state, ttr = pretrain_pair(monkeypatch, skip_mode="real",
                                    geometry=geometry, **cfg_kw)
    out.append((_recipe("pretrain", ttr, (ttr.cfg, ttr.loss, TRAIN_LR), {},
                      {"opt_en": TRAIN_LR, "opt_de": TRAIN_LR},
                      train_wav(1, b, length)),
                jtr, state, {"enc": ("enc",), "dec": ("dec",)}))
    jtr, state, ttr = nsvae_pair({"clean_enc": True}, geometry=geometry,
                                 **cfg_kw)
    out.append((_recipe("nsvae", ttr,
                      (ttr.pre_cfg, ttr.noisy_cfg, ttr.loss, TRAIN_LR),
                      {"trainable": ttr.trainable}, {"opt": TRAIN_LR},
                      tuple(train_wav(s, b, length) for s in (2, 3, 4))),
                jtr, state, {n: ("models", n) for n in ttr.models}))
    jtr, state, ttr = phase2_pair(monkeypatch, adversarial=True, d_step=2,
                                  enc_kw=cfg_kw, dec_kw=cfg_kw,
                                  geometry=geometry)
    out.append((_recipe("phase2", ttr,
                      (ttr.enc_cfg, ttr.dec_cfg, ttr.loss, PHASE2_LR),
                      dict(adversarial=True, dis_lr=2 * PHASE2_LR, d_step=2),
                      {"opt": PHASE2_LR, "opt_dis": 2 * PHASE2_LR},
                      tuple(phase2_wav(s, b, length) for s in (5, 6, 7))),
                jtr, state, {n: ("models", n) for n in ttr.models}))
    jtr, state, ttr = supervised_pair(False, geometry=geometry,
                                      **cfg_kw)
    out.append((_recipe("supervised", ttr, (ttr.cfg, ttr.loss, TRAIN_LR), {},
                      {"opt": TRAIN_LR},
                      tuple(train_wav(s, b, length) for s in (8, 9))),
                jtr, state, {"model": ("model",)}))
    # the pair helpers route the port's draws through fixed streams: the
    # steps here draw from their generators
    for module in ("vae", "nsvae"):
        monkeypatch.setattr(f"idccrn_vae_torch.models.{module}."
                            "reparameterize", reparam.reparameterize)
    return out


def state_at(state, path):
    for key in path:
        state = state[key]
    return state


def port_step(monkeypatch, recipe):
    """The recipe's step in this process (no process group) -> (metrics,
    model state, the (eps_r, eps_i) pairs its encoders drew)."""
    import torch_port_ranks as ranks
    from idccrn_vae_torch.models import reparam

    rec = Recorder(reparam.randn_rows)
    monkeypatch.setattr(reparam, "randn_rows", rec)
    try:
        metrics, state = ranks.run_step(recipe)
    finally:
        monkeypatch.setattr(reparam, "randn_rows", rec.fn)
    return metrics, state, rec.pairs()


def jax_step(monkeypatch, jtr, state, recipe, pairs, mesh=None):
    """The JAX trainer's step on the recipe's batch and epoch, its
    encoders handed `pairs`; on `mesh` when given (the trainer's own mesh
    is restored after). Returns (new state, metrics)."""
    from idccrn_vae_tpu.parallel.mesh import replicate

    saved = jtr.mesh
    if mesh is not None:
        jtr.mesh, state = mesh, replicate(mesh, state)
    try:
        patch_jax_draws(monkeypatch, pairs)
        return jtr.train_step(state, recipe["batch"], jax.random.PRNGKey(0),
                              recipe["epoch"])
    finally:
        jtr.mesh = saved


def check_step_against_jax(recipe, metrics, state, jax_metrics, jax_state,
                           paths):
    """A port step's metrics (F32_TOL) and every model's updates,
    statistics and counters (`check_models`) against the JAX step's."""
    import torch_port_ranks as ranks
    from idccrn_vae_torch.models.modules import set_bn_counts

    check_metrics(metrics, jax_metrics)
    trainer = ranks.build(recipe)
    for name, path in paths.items():
        module = trainer.models[name]
        module.load_state_dict(state[name][0])
        set_bn_counts(module, state[name][1])
        check_models(module, recipe["models"][name][0],
                     state_at(jax_state, path), f"{recipe['kind']} {name}",
                     prefix="std_DCCRN" if recipe["kind"] == "supervised"
                     else "")


# ------------------------------------------- whole fits (trajectories)


def fit_both(shared, stage, jtr, ttr, train, val, tmp_path, epochs,
             early_stop_patience=10):
    """`fit` of the JAX trainer, then of the port's, on the same loaders
    inside `shared` (a `port_tools.trajectory_parity.SharedRun` whose
    patches are installed); returns the comparison of the two."""
    kw = dict(epochs=epochs, early_stop_patience=early_stop_patience,
              save_frequency=1)
    for side, tr in (("jax", jtr), ("port", ttr)):
        with shared.running(stage, side):
            tr.fit(train, val, save_dir=str(tmp_path / side), **kw)
    return shared.compare(stage)


def assert_trajectory_match(cmp):
    """Equal discrete decisions and every loss within the bound."""
    assert cmp["lr_match"] and cmp["kl_weight_match"], cmp
    assert cmp["improved_match"] and cmp["epochs_run_match"], cmp
    assert cmp["first_fail"] is None, cmp["per_epoch"]
    assert cmp["ok"]


# ------------------------------------------------- the bf16 yardstick
#
# A bf16 step is held against the float32 truth, not against the other
# framework's bf16 step. Three steps run from the same weights, batch and
# latent draws: JAX at f32 (the truth), JAX at bf16 and the port at bf16.
# Each quantity q (a loss component, a model's whole update, one
# parameter's update, a serving output) passes when
#
#   dist(q_port_bf16, q_jax_f32) <= YARD_RATIO * dist(q_jax_bf16, q_jax_f32)
#                                   + YARD_FLOOR
#
# with dist the relative L2 distance (for a scalar loss |a - b| / |b|).
#
# Why not port bf16 against JAX bf16: each side's bf16 result is the f32
# result plus its own rounding error e. The two frameworks round at
# different points inside a conv (accumulation order, when the f32
# accumulator is rounded), so e_port and e_jax are two draws of one
# process and |port - jax| = |e_port - e_jax| is about sqrt(2) times
# either, whatever bound a tiny model gives it. At the reference
# geometry a CVAE step's e is ~0.14 of the encoder's update on either
# side (tests/test_torch_port_fullwidth.py; FULLWIDTH_PARITY_TORCH.json),
# so the JAX-bf16 distance passes a 0.1 bound set at the tiny geometry
# (tests/test_torch_port_bf16_steps.py) on rounding noise alone, and a
# port fault as small as the noise could hide in it. Measured from the
# truth, a fault adds to the port's distance alone.
#
# The constants, derived from FULLWIDTH_PARITY_TORCH.json (5 seeds, the
# six train steps and four serving programs at the reference geometry;
# two draws of one error process differ in size by their sampling
# spread, and the port's draw is as often the smaller as the larger):
#   YARD_RATIO = 1.75 for losses, outputs and whole updates. Over the 55
#     whole-update rows the port/JAX ratio lies in 0.92-1.05, except the
#     Discriminator's 1.20 and 1.59: its update flows from its four scores
#     at B=2, a few-draw quantity. 1.75 holds 1.59 with 10% room.
#   PARAM_RATIO = 2.5 for single parameters, fewer draws each: over 2637
#     parameters above the floor (PReLU slopes aside) the ratio has median
#     0.999, 99th percentile 1.58 and maximum 2.10; over 359 slopes median
#     0.97, the port's the larger in 47%. The largest port distance over
#     its reference (below) is 2.35. A dropped gradient (distance 1) stays
#     past it wherever JAX's own distance is under 0.39.
#   YARD_FLOOR = BF16_REL: a quantity whose JAX-bf16 distance is near zero
#     by chance (167 of 170 loss rows read under 0.02) gets the bf16
#     tolerance of one stage of the suite's op tests.
#   SPREAD_K = 3: a parameter's reference is the larger of JAX's distance
#     and SPREAD_K times an expected spread, so that a parameter whose
#     JAX draw came out small is not held to it. A PReLU slope's gradient
#     is one sum over a whole activation map, sum(ct * min(x, 0)), which
#     cancels: its spread is JAX's whole-update distance times kappa, the
#     L2 norm of the sum's terms over the sum (`SlopeTerms`; the median of
#     JAX's slope distance over it is 0.68). Any parameter's spread is at
#     least its `even_share` of JAX's whole-update distance: an update near
#     zero by the model's structure (a last decoder stage's BN gamma_ri)
#     carries only its share of the model's error. 3 is three standard
#     deviations of one draw.
#
# Two kinds of quantity are held otherwise, as in
# tests/test_torch_port_bf16_steps.py: a conv bias feeding a train-mode
# BN has an update that is zero in exact arithmetic (the BN subtracts the
# channel's batch mean), so its bf16 update is held to BF16_REL of the
# model's whole update (its share); and the JAX side's PReLU slope
# cotangent is summed in float32 (`f32_slope_prelu`), as JAX's own sum of
# a bf16 array is, because XLA:CPU reduces the transposed broadcast in
# bf16 and its result then depends on the order of the sum.

YARD_RATIO = 1.75
PARAM_RATIO = 2.5
YARD_FLOOR = BF16_REL
SPREAD_K = 3.0


def f32_slope_prelu():
    """The JAX PReLU with its slope's cotangent summed in float32: the
    same forward and input cotangent, the same bf16 products ct * x."""

    @jax.custom_vjp
    def prelu(x, alpha):
        return jnp.where(x >= 0, x, alpha.astype(x.dtype) * x)

    def fwd(x, alpha):
        return prelu(x, alpha), (x, alpha)

    def bwd(res, ct):
        x, alpha = res
        neg = x < 0
        ct_x = jnp.where(neg, alpha.astype(x.dtype) * ct, ct)
        terms = jnp.where(neg, ct * x, jnp.zeros_like(x))
        return ct_x, jnp.sum(terms.astype(jnp.float32)).astype(alpha.dtype)

    prelu.defvjp(fwd, bwd)
    return prelu


class SeededDraws:
    """Latent draws for both sides that a jitted JAX step fetches at run
    time (`jax.pure_callback`), so one compiled step sees the draws of
    whichever seed `set` chose last. Draws are keyed by shape, the same
    for every call of one shape (`FixedNoise`): phase 2's JAX step encodes
    a D-update batch twice, the port once."""

    def __init__(self, seed: int = 0):
        self.set(seed)

    def set(self, seed: int) -> None:
        self.noise = FixedNoise(seed)

    def install(self, monkeypatch) -> None:
        """Route both packages' encoder draws (VAE and NSVAE) here."""
        from idccrn_vae_tpu.models.reparam import reparameterize as j_rep
        from idccrn_vae_torch.models.reparam import reparameterize as t_rep

        def jax_fixed(rng, g, num_samples, guard="eps", noise=None):
            shape = (g.mu_r.shape[0], num_samples, *g.mu_r.shape[1:])
            e = jax.pure_callback(
                lambda: np.stack(self.noise(*shape)),
                jax.ShapeDtypeStruct((2, *shape), jnp.float32))
            return j_rep(rng, g, num_samples, guard=guard,
                         noise=(e[0], e[1]))

        def port_fixed(g, num_samples, guard="eps", noise=None,
                       generator=None):
            shape = (g.mu_r.shape[0], num_samples, *g.mu_r.shape[1:])
            er, ei = self.noise(*shape)
            return t_rep(g, num_samples, guard=guard,
                         noise=(torch.from_numpy(er), torch.from_numpy(ei)))

        for module in ("vae", "nsvae"):
            monkeypatch.setattr(f"idccrn_vae_tpu.models.{module}."
                                "reparameterize", jax_fixed)
            monkeypatch.setattr(f"idccrn_vae_torch.models.{module}."
                                "reparameterize", port_fixed)


def rel_dist(got, want) -> float:
    """Relative L2 distance |got - want| / |want| in float64; a scalar's
    relative error; 0 when both are zero."""
    got, want = (x.detach().double().cpu().numpy()
                 if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)
                 for x in (got, want))
    err = float(np.linalg.norm(got - want))
    scale = float(np.linalg.norm(want))
    return err / scale if scale > 0 else err


def bn_fed_bias(name: str) -> bool:
    """A conv bias ahead of a train-mode BN (zero update in exact
    arithmetic), as tests/test_torch_port_bf16_steps.py names them."""
    return name.endswith("bias") and "conv" in name


def port_update(module, before) -> dict:
    """Each parameter's update of a port module after a step, float64."""
    after = module.state_dict()
    return {k: (after[k] - before[k]).double()
            for k, _ in module.named_parameters()}


def jax_update(module, before, jax_after, prefix="") -> dict:
    """Each parameter's update in the JAX variables after a step, in the
    port module's names and shapes, float64."""
    want = state_dict_of(jax_after, prefix)
    shapes = dict(module.state_dict())
    return {k: (want[k].reshape(shapes[k].shape) - before[k]).double()
            for k, _ in module.named_parameters()}


def slope_kappa(slope_terms, name, update):
    """A PReLU slope's kappa: the L2 norm of its gradient's terms (in
    update units, `SlopeTerms`) over its f32 update; None for any other
    parameter."""
    if name not in slope_terms:
        return None
    return slope_terms[name] / max(float(update.norm()), 1e-30)


def even_share(n, n_model, share):
    """A parameter's even share of its model's error, relative to its own
    update: sqrt(n / n_model) / share, for a parameter of n of the
    model's n_model elements whose update is `share` of the model's."""
    return (n / n_model) ** 0.5 / max(share, 1e-30)


def judge_row(r) -> dict:
    """A yardstick row with its bound and verdict: a BN-fed conv bias's
    share within BF16_REL; a loss, an output or a whole update within
    YARD_RATIO times JAX's distance plus YARD_FLOOR; a parameter within
    PARAM_RATIO times the larger of JAX's distance and SPREAD_K times its
    expected spread (a PReLU slope's `spread`, its `even` share of JAX's
    model distance), plus YARD_FLOOR."""
    if r["kind"] == "bias_share":
        r["bound"] = BF16_REL
    else:
        ref = max(r["jax"], SPREAD_K * (r.get("spread") or 0.0),
                  SPREAD_K * (r.get("even") or 0.0))
        ratio = PARAM_RATIO if r["kind"] == "param" else YARD_RATIO
        r["bound"] = ratio * ref + YARD_FLOOR
    r["ok"] = bool(r["port"] <= r["bound"])
    return r


def yardstick(port, jax_bf16, jax_f32) -> list:
    """Rows of the bf16 yardstick for one step or program. Each side is
    {"losses": {name: float}, "updates": {model: {param: delta}},
    "outputs": {name: array}} (any part may be missing). A row is
    {kind, name, port, jax, bound, ok, share, spread, even}: kind "loss",
    "output", "model" (a whole update), "param", or "bias_share" (a
    BN-fed conv bias: its bf16 update's share of the model's, bound
    BF16_REL, "jax" the JAX bf16 share); `share` is a parameter's f32
    update as a share of its model's; `spread` a PReLU slope's expected
    distance (JAX's model distance times its kappa); `even` a parameter's
    even share of JAX's model distance (`even_share`)."""
    rows = []

    def row(kind, name, d_port, d_jax, share=None, spread=None, even=None):
        rows.append(judge_row(dict(kind=kind, name=name, port=d_port,
                                   jax=d_jax, share=share, spread=spread,
                                   even=even)))

    for part, kind in (("losses", "loss"), ("outputs", "output")):
        want = jax_f32.get(part, {})
        assert set(port.get(part, {})) == set(jax_bf16.get(part, {})) \
            == set(want), part
        for k in want:
            row(kind, k, rel_dist(port[part][k], want[k]),
                rel_dist(jax_bf16[part][k], want[k]))
    for model, want in jax_f32.get("updates", {}).items():
        got, ref = port["updates"][model], jax_bf16["updates"][model]
        assert set(got) == set(ref) == set(want), model
        cat = lambda d: torch.cat([d[k].flatten() for k in sorted(want)])
        whole = {s: cat(d) for s, d in (("port", got), ("jax", ref),
                                        ("f32", want))}
        model_jax = rel_dist(whole["jax"], whole["f32"])
        row("model", model, rel_dist(whole["port"], whole["f32"]),
            model_jax)
        for k in want:
            # the parameter's f32 update as a share of the model's
            f32_share = float(want[k].norm() / whole["f32"].norm())
            if bn_fed_bias(k):
                share = lambda d, s: float(d[k].norm() / whole[s].norm())
                row("bias_share", f"{model}.{k}", share(got, "port"),
                    share(ref, "jax"), share=f32_share)
                continue
            kappa = slope_kappa(jax_f32.get("slope_terms", {}),
                                f"{model}.{k}", want[k])
            row("param", f"{model}.{k}", rel_dist(got[k], want[k]),
                rel_dist(ref[k], want[k]), share=f32_share,
                spread=None if kappa is None else model_jax * kappa,
                even=model_jax * even_share(want[k].numel(),
                                            whole["f32"].numel(), f32_share))
    return rows


def check_yardstick(rows, what=""):
    """Every row of `yardstick` within its bound; returns the margins: the
    largest port distance per kind and the largest port/bound ratio."""
    bad = [r for r in rows if not r["ok"]]
    assert not bad, (what, bad[:8])
    out = {}
    for r in rows:
        out[r["kind"]] = max(out.get(r["kind"], 0.0), r["port"])
    out["worst_of_bound"] = max(r["port"] / r["bound"] for r in rows)
    return out
