"""Reference-geometry parity: every train step and serving program of the
port against the JAX package on the CPU, at float32 and bf16, over seeds.

The geometry is `DccrnConfig()`'s (channels 1-32-64-128-128-256-256,
zdim 128, LSTM hidden 128) with each side's default STFT (n_fft 512,
hop 100, 257 bins): the widths the card trains and serves at. The cases
are built with the parity suite's helpers (tests/torch_port_util.py at
`geometry="reference"`), so this tool and tests/test_torch_port_fullwidth.py
run one recipe:

  train steps (SGD, so an update is the gradient times the learning rate)
    pretrain_zero  CVAE pretraining, skip_mode zero
    pretrain_real  CVAE pretraining, real skips, the MI term on
    nsvae          NSVAE posterior matching, the clean encoder trained
                   beside the noisy one, the noise encoder frozen
    phase2         classical phase 2, latent_num 2 (both decoders)
    phase2_adv     adversarial phase 2, d_step 1, latent_num 2
                   (decoder and Discriminator)
    supervised     the supervised DCCRN with datanorm
  serving programs
    clean_direct   `Enhancer.forward`, latent_to_use 1
    dual_mask      the latent_num 2 complex_mask program: each decoder's
                   spectrum, and the combination on shared inputs (the
                   end-to-end waveform, ill-conditioned where S ~ -N, is
                   reported, not held)
    stream_chunk   one `StreamingEnhancer.process_chunk` (10 frames) from
                   a fresh state: the output and every carried state leaf
    supervised_fwd `SupervisedDccrn.forward` with datanorm (waveform and
                   spectrum)

For each case and seed (the seed picks the JAX init, the batch and the
latent draws):
  * f32: the port against JAX, as margins (error over tolerance; <= 1
    passes): losses and serving outputs at F32_TOL; BN statistics at
    F32_TOL and BN counters equal; each parameter's update in relative L2
    within `f32_param_bound` (`check_models_l2`). The element-by-element
    GRAD_TOL margin of `check_models` is reported beside it, and for
    `--jax-eager` cases the same margins between JAX's jitted step and
    the same step run op by op: JAX's own f32 spread at this geometry;
  * bf16: JAX f32 is the truth; the port's bf16 distance from it and
    JAX's bf16 distance from it, for each loss component, output, model
    update and parameter update, with their ratio and the yardstick
    `dist_port <= YARD_RATIO * dist_jax + YARD_FLOOR` (torch_port_util,
    where RATIO and FLOOR are derived).
The report also lists, for each side, the 10 parameters whose bf16
update lies furthest from the f32 update, over every train case and
seed: which parameters carry the bf16 error.

Cuts, all listed in the report: the batch (the inis' 16 or 24 -> --batch)
and the segment (481 frames -> --samples); num_samples 2 in pretraining
(the suite's recipe; the ini's usage line has 5). No width is cut.

  python -m port_tools.fullwidth_parity            # 5 seeds, every case

writes FULLWIDTH_PARITY_TORCH.json (or --out). It needs JAX and both
packages, so it runs on the CPU of a machine that has both; the port
runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CASES = ("pretrain_zero", "pretrain_real", "nsvae", "phase2",
               "phase2_adv", "supervised")
SERVE_CASES = ("clean_direct", "dual_mask", "stream_chunk",
               "supervised_fwd")
# the inis' [DataFrame] batch_size of each trainer (configs/*.ini)
INI_BATCH = {"pretrain_zero": 16, "pretrain_real": 16, "nsvae": 24,
             "phase2": 16, "phase2_adv": 16, "supervised": 16}
INI_FRAMES = 481
STREAM_CHUNK_FRAMES = 10
TOP = 10


def util():
    """tests/torch_port_util, with JAX on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_port_util

    return torch_port_util


# ------------------------------------------------------------- margins


def _allclose_margin(got, want, atol, rtol) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 is assert_allclose's
    pass."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size == 0:
        return 0.0
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def f32_model_margins(U, module, before, jax_after, prefix="",
                      terms=None, model=""):
    """`check_models`' criteria as margins: parameter updates (GRAD_TOL,
    element by element), buffers (F32_TOL), BN counters equal; and
    `check_models_l2`'s: the largest relative L2 distance of one
    parameter's update (BN-fed conv biases aside), and the largest over
    its `f32_param_bound` (`terms`: the step's slope terms; [relative L2,
    kappa, even share] of every slope and of every parameter past half of
    GRAD_TOL's rtol is kept for --rejudge)."""
    import torch

    from idccrn_vae_torch.models.from_jax import jax_bn_counts
    from idccrn_vae_torch.models.modules import ComplexBatchNorm

    want = U.state_dict_of(jax_after, prefix)
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    names = [n for n, _ in module.named_parameters()]
    grad, buf, rel, worst, checked = 0.0, 0.0, 0.0, "", {}
    flat = torch.cat([(want[k].reshape(got[k].shape) - before[k]).flatten()
                      for k in names]).double()
    for k in want:
        w = want[k].reshape(got[k].shape)
        if k in names:
            d_got, d_want = got[k] - before[k], w - before[k]
            grad = max(grad, _allclose_margin(d_got.numpy(), d_want.numpy(),
                                              **U.GRAD_TOL))
            if U.bn_fed_bias(k):
                continue
            r = U.rel_dist(d_got, d_want)
            if r > rel:
                rel, worst = r, k
            kappa = U.slope_kappa(terms or {}, f"{model}.{k}",
                                  d_want.double())
            even = U.even_share(d_want.numel(), flat.numel(),
                                float(d_want.double().norm() / flat.norm()))
            # below half of rtol no allowance can matter: not kept
            if kappa is not None or r > U.GRAD_TOL["rtol"] / 2:
                checked[k] = [r, kappa, even]
        else:
            buf = max(buf, _allclose_margin(got[k].numpy(), w.numpy(),
                                            **U.F32_TOL))
    counts = jax_bn_counts(U.np_vars(jax_after), prefix)
    counts_ok = all(int(m.count) == counts[n]
                    for n, m in module.named_modules()
                    if isinstance(m, ComplexBatchNorm))
    out = dict(grad=grad, buffer=buf, counts_equal=counts_ok,
               worst_param_rel_l2=rel, worst_param=worst, checked=checked)
    return judge_f32_model(U, out)


def f32_train_ok(f32) -> bool:
    """A train step's f32 verdict: losses at F32_TOL, frozen models
    untouched, every parameter within its `f32_param_bound`, buffers at
    F32_TOL, counters equal."""
    return bool(f32["loss"] <= 1 and f32["frozen_unchanged"]
                and all(m["param_of_bound"] <= 1 and m["buffer"] <= 1
                        and m["counts_equal"]
                        for m in f32["models"].values()))


def judge_f32_model(U, m):
    """`param_of_bound` of a model's f32 record: the largest relative L2
    over its `f32_param_bound` among the kept parameters (every slope, and
    every other parameter past half of GRAD_TOL's rtol), 0.5 when none."""
    m["param_of_bound"] = max(
        [0.5] + [r / U.f32_param_bound(kappa, even)
                 for r, kappa, even in m["checked"].values()])
    return m


def losses_of(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


# ---------------------------------------------------------- train steps


def _paths(kind, ttr):
    if kind == "pretrain":
        return {"enc": ("enc",), "dec": ("dec",)}
    if kind == "supervised":
        return {"model": ("model",)}
    return {n: ("models", n) for n in ttr.models}


def train_pairs(U, mp, case, compute, seed):
    """(kind, epoch, JAX trainer, JAX state, port trainer) of `case` at
    the reference geometry and `compute`, the JAX init from `seed`."""
    geo = dict(geometry="reference", seed=seed)
    if case.startswith("pretrain"):
        skip = "zero" if case == "pretrain_zero" else "real"
        return ("pretrain", 1, *U.pretrain_pair(mp, skip_mode=skip,
                                                compute=compute, **geo))
    if case == "nsvae":
        return ("nsvae", 0, *U.nsvae_pair({"clean_enc": True},
                                          compute=compute, **geo))
    if case.startswith("phase2"):
        kw = dict(latent_num=2, enc_kw={"compute": compute},
                  dec_kw={"compute": compute})
        if case == "phase2_adv":
            kw.update(adversarial=True, d_step=1)
        return ("phase2", 0, *U.phase2_pair(mp, **kw, **geo))
    return ("supervised", 0, *U.supervised_pair(True, compute=compute,
                                                **geo))


def train_batch(U, kind, seed, b, n):
    if kind == "pretrain":
        return U.train_wav(100 * seed + 1, b, n)
    if kind == "phase2":
        return U.phase2_batch(100 * seed + 5, b, n)
    k = 3 if kind == "nsvae" else 2
    return tuple(U.train_wav(100 * seed + 20 + i, b, n) for i in range(k))


class SlopeTerms:
    """The terms of each PReLU slope's gradient in a port step: a slope's
    gradient is one sum over a whole activation map, sum(ct * min(x, 0)),
    which cancels heavily. Records, per slope parameter, the L2 norm of
    its terms (the sum's spread if each term carries an independent
    relative error) during the backward of steps run inside `recording`."""

    def __init__(self, mp):
        import idccrn_vae_torch.models.modules as modules

        self.sq, self.on = {}, False
        original = modules.prelu

        def prelu(x, alpha):
            out = original(x, alpha)
            if self.on and out.requires_grad:
                neg = x.detach().float().clamp(max=0)
                key = id(alpha)

                def hook(ct):
                    t = (ct.float() * neg).double()
                    self.sq[key] = self.sq.get(key, 0.0) + float((t * t).sum())

                out.register_hook(hook)
            return out

        mp.setattr(modules, "prelu", prelu)

    def recording(self):
        self.sq = {}
        return self

    def __enter__(self):
        self.on = True

    def __exit__(self, *exc):
        self.on = False

    def l2(self, models) -> dict:
        """{"model.param": L2 norm of its gradient's terms}."""
        names = {id(p): f"{m}.{k}" for m, mod in models.items()
                 for k, p in mod.named_parameters()}
        return {names[i]: v ** 0.5 for i, v in self.sq.items() if i in names}


class TrainCase:
    """One train case: JAX f32 and bf16 trainers and port f32 and bf16
    trainers, built once (each JAX step compiles once) and reseeded per
    seed by loading new JAX weights."""

    def __init__(self, U, mp, draws, name, b, n):
        self.U, self.name, self.b, self.n, self.draws = U, name, b, n, draws
        self.slopes = SlopeTerms(mp)
        (self.kind, self.epoch, self.j32, self.state0,
         self.t32) = train_pairs(U, mp, name, "f32", 0)
        _, _, self.j16, _, self.t16 = train_pairs(U, mp, name, "bf16", 0)
        self.paths = _paths(self.kind, self.t32)
        self.prefix = "std_DCCRN" if self.kind == "supervised" else ""

    def _load(self, state):
        from idccrn_vae_torch.models.from_jax import load_jax_variables

        U = self.U
        for ttr in (self.t32, self.t16):
            for name, path in self.paths.items():
                load_jax_variables(ttr.models[name],
                                   U.np_vars(U.state_at(state, path)))

    def _jax_step(self, jtr, state, batch):
        import jax

        jtr._batch_counter = 0
        s1, metrics = jtr.train_step(state, batch, jax.random.PRNGKey(0),
                                     self.epoch)
        return jax.block_until_ready(s1), losses_of(metrics)

    def _port_step(self, ttr, batch):
        """(state_dicts before, losses, each model's parameter updates)."""
        if hasattr(ttr, "_batch_counter"):
            ttr._batch_counter = 0
        before = {n: self.U.clone_state(m) for n, m in ttr.models.items()}
        losses = losses_of(ttr.train_step(batch, None, self.epoch))
        return before, losses, {n: self.U.port_update(m, before[n])
                                for n, m in ttr.models.items()}

    def seed(self, seed):
        """Load `seed`'s JAX init into the port trainers, point the draws
        at it; returns (JAX state, batch)."""
        import jax

        state = (self.state0 if seed == 0 else
                 self.j32.init_state(jax.random.PRNGKey(seed)))
        self._load(state)
        self.draws.set(seed)
        return state, train_batch(self.U, self.kind, seed, self.b, self.n)

    def steps(self, seed, port_f32=True):
        """The steps of one seed: JAX f32 and bf16, then the port's bf16
        (and f32) from the same weights, batch and draws. Returns a dict:
        j32/j16 (JAX state after, losses), p32/p16 (port state_dicts
        before, losses, updates), slope_terms (with the f32 port step: each PReLU
        slope's `SlopeTerms` L2 norm times its learning rate, in update
        units)."""
        state, batch = self.seed(seed)
        out = {"j32": self._jax_step(self.j32, state, batch),
               "j16": self._jax_step(self.j16, state, batch),
               "p16": self._port_step(self.t16, batch)}
        if port_f32:
            with self.slopes.recording():
                out["p32"] = self._port_step(self.t32, batch)
            lr = {id(p): g["lr"] for opt in self.t32.optimizers.values()
                  for g in opt.param_groups for p in g["params"]}
            names = {f"{m}.{k}": lr[id(p)]
                     for m, mod in self.t32.models.items()
                     for k, p in mod.named_parameters() if id(p) in lr}
            out["slope_terms"] = {k: v * names[k] for k, v in
                                  self.slopes.l2(self.t32.models).items()
                                  if k in names}
        return out

    def port_bf16(self, seed):
        """The port's bf16 step of `seed` alone (before, losses,
        updates)."""
        _, batch = self.seed(seed)
        return self._port_step(self.t16, batch)

    def trained(self, res):
        """The models the JAX f32 step updated (the frozen ones aside)."""
        s32, _ = res["j32"]
        b16 = res["p16"][0]
        out = []
        for name, path in self.paths.items():
            want = self.U.jax_update(self.t16.models[name], b16[name],
                                     self.U.state_at(s32, path), self.prefix)
            if any(float(d.abs().max()) > 0.0 for d in want.values()):
                out.append(name)
        return out

    def sides(self, res):
        """The yardstick's three sides (port bf16, JAX bf16, JAX f32) of
        `steps`' results: losses and the trained models' updates."""
        U = self.U
        (s32, l32), (s16, l16) = res["j32"], res["j16"]
        b16, p16, u16 = res["p16"]
        out = {s: {"losses": l, "updates": {}} for s, l in
               (("port", p16), ("jax", l16), ("f32", l32))}
        out["f32"]["slope_terms"] = res.get("slope_terms", {})
        for name in self.trained(res):
            path, m16 = self.paths[name], self.t16.models[name]
            for side, st in (("f32", s32), ("jax", s16)):
                out[side]["updates"][name] = U.jax_update(
                    m16, b16[name], U.state_at(st, path), self.prefix)
            out["port"]["updates"][name] = u16[name]
        return out

    def jax_eager(self, seed, res):
        """JAX's f32 step once more, op by op (`jax.disable_jit`): another
        summation order of the same program. Its updates against the jitted
        step's, by `f32_model_margins`' measures: JAX's own f32 spread."""
        import jax

        state, batch = self.seed(seed)
        self.j32._batch_counter = 0
        with jax.disable_jit():
            eager, _ = self.j32.train_step(state, batch,
                                           jax.random.PRNGKey(0), self.epoch)
        s32 = res["j32"][0]
        out = {}
        for name in self.trained(res):
            path, m = self.paths[name], self.t32.models[name]
            before = res["p32"][0][name]
            want = self.U.jax_update(m, before, self.U.state_at(s32, path),
                                     self.prefix)
            got = self.U.jax_update(m, before,
                                    self.U.state_at(eager, path), self.prefix)
            rel = max((self.U.rel_dist(got[k], want[k]), k) for k in want
                      if not self.U.bn_fed_bias(k))
            out[name] = dict(grad=max(
                _allclose_margin(got[k].numpy(), want[k].numpy(),
                                 **self.U.GRAD_TOL) for k in want),
                worst_param_rel_l2=rel[0], worst_param=rel[1])
        return out

    def run(self, seed, eager=False):
        """The four steps of one seed -> (f32 record, yardstick rows);
        `eager`: JAX's f32 step op by op too (`jax_eager`)."""
        U = self.U
        res = self.steps(seed)
        (s32, l32), (b32, p32, u32), (b16, p16, u16) = (
            res["j32"], res["p32"], res["p16"])
        if not set(p32) == set(l32) == set(p16) == set(res["j16"][1]):
            raise AssertionError(f"{self.name}: loss keys differ")
        f32 = dict(loss=max(_allclose_margin(p32[k], l32[k], **U.F32_TOL)
                            for k in l32), models={})
        trained = self.trained(res)
        frozen_ok = True
        for name, path in self.paths.items():
            m32, m16 = self.t32.models[name], self.t16.models[name]
            if name in trained:
                f32["models"][name] = f32_model_margins(
                    U, m32, b32[name], U.state_at(s32, path), self.prefix,
                    res["slope_terms"], name)
                continue
            # frozen: every side leaves it alone
            frozen_ok &= all(
                all(float(d.abs().max()) == 0.0 for d in upd.values())
                for upd in (u32[name], u16[name]))
        f32["frozen_unchanged"] = bool(frozen_ok)
        f32["ok"] = f32_train_ok(f32)
        if eager:
            f32["jax_eager"] = self.jax_eager(seed, res)
        sides = self.sides(res)
        return f32, U.yardstick(sides["port"], sides["jax"], sides["f32"])


# ---------------------------------------------------- serving programs


def _capture_spectra(mp, module, calls):
    """Record the (speech, noise, noisy) spectra `module`'s Enhancer
    hands to its combine_outputs."""
    original = module.combine_outputs

    def recording(outtype, speech, noise, noisy, num_samples):
        calls.append((speech, noise, noisy))
        return original(outtype, speech, noise, noisy, num_samples)

    mp.setattr(module, "combine_outputs", recording)


class ServeCase:
    """One serving program on both sides at f32 and bf16; the JAX
    programs are built once and take each seed's variables."""

    def __init__(self, U, mp, draws, name, b, n):
        self.U, self.mp, self.name, self.b, self.n = U, mp, name, b, n
        self.draws = draws
        self.jax_programs = {}
        self.spectra = {"jax": [], "port": []}
        if name == "dual_mask":
            from idccrn_vae_tpu.eval import enhance as jenh
            from idccrn_vae_torch.eval import enhance as tenh

            _capture_spectra(mp, jenh, self.spectra["jax"])
            _capture_spectra(mp, tenh, self.spectra["port"])

    def _configs(self, compute):
        U = self.U
        if self.name == "clean_direct":
            jc, tc = U.configs("reference", compute=compute)
            return (jc, jc), (tc, tc)
        if self.name == "dual_mask":
            import dataclasses

            jc, tc = U.configs("reference", compute=compute, latent_num=2,
                               channel_mode="double")
            return ((jc, dataclasses.replace(jc, latent_num=1,
                                             channel_mode="normal")),
                    (tc, dataclasses.replace(tc, latent_num=1,
                                             channel_mode="normal")))
        if self.name == "stream_chunk":
            jc, tc = U.configs("reference", compute=compute, causal=True,
                               recon_type="mask")
            return (jc, jc), (tc, tc)
        jc, tc = U.configs("reference", compute=compute, causal=True,
                           recon_type="mask", skip_mode="real")
        return (jc, jc), (tc, tc)

    def _variables(self, seed):
        import jax

        from idccrn_vae_tpu.models.dccrn import SupervisedDccrn as JSup
        from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JEnc
        from idccrn_vae_tpu.models.vae import VaeDecoder as JDec

        U = self.U
        (jenc, jdec), _ = self._configs("f32")
        keys = jax.random.split(jax.random.PRNGKey(1000 + seed), 3)
        if self.name == "supervised_fwd":
            dn = U.datanorm_stats(seed, U.freq_bins("reference"))
            return dict(model=U.np_vars(JSup(jenc).init(keys[0])), dn=dn)
        out = dict(enc=U.np_vars(JEnc(jenc).init(keys[0])),
                   dec=U.np_vars(JDec(jdec).init(keys[1])))
        if self.name == "dual_mask":
            out["noise"] = U.np_vars(JDec(jdec).init(keys[2]))
        return out

    def _jax(self, compute, v, wav):
        import jax
        import jax.numpy as jnp

        from idccrn_vae_tpu.eval import enhance as jenh
        from idccrn_vae_tpu.eval.streaming import StreamingEnhancer as JStr
        from idccrn_vae_tpu.models.dccrn import SupervisedDccrn as JSup

        U = self.U
        (jc, jdc), _ = self._configs(compute)
        if self.name in ("clean_direct", "dual_mask"):
            if compute not in self.jax_programs:
                kw = dict(num_samples=1)
                if self.name == "dual_mask":
                    kw.update(outtype="complex_mask", latent_to_use=2)
                self.jax_programs[compute] = jenh.Enhancer(
                    jc, jdc, v["enc"], v["dec"], v.get("noise"), **kw)
            ref = self.jax_programs[compute]
            # the dual program runs eagerly, so its spectra are values
            fn = ref.forward if self.name == "dual_mask" else ref._fn
            out = fn(v["enc"], v["dec"], v.get("noise"), jnp.asarray(wav),
                     jax.random.PRNGKey(0))
            if self.name == "clean_direct":
                return {"wav": U.to_np(out)}
            speech, noise, noisy = map(U.to_np, self.spectra["jax"][-1])
            return {"speech_spec": speech, "noise_spec": noise,
                    "noisy_spec": noisy, "wav": U.to_np(out)}
        if self.name == "stream_chunk":
            ref = JStr(jc, jdc, v["enc"], v["dec"],
                       chunk_frames=STREAM_CHUNK_FRAMES)
            out, st = ref.process_chunk(ref.init_state(self.b), wav)
            return {"chunk": U.to_np(out),
                    **{f"state{i}": U.to_np(x)
                       for i, x in enumerate(_leaves(st))}}
        model = JSup(jc, tuple(map(jnp.asarray, v["dn"])))
        (w, spec), _ = jax.jit(
            lambda variables, x: model.apply(variables, x, train=False))(
                v["model"], jnp.asarray(wav))
        return {"wav": U.to_np(w), "spec": U.to_np(spec)}

    def _port(self, compute, v, wav):
        import torch

        from idccrn_vae_torch.eval import enhance as tenh
        from idccrn_vae_torch.eval.streaming import StreamingEnhancer
        from idccrn_vae_torch.models.dccrn import SupervisedDccrn
        from idccrn_vae_torch.models.from_jax import load_jax_variables
        from idccrn_vae_torch.models.nsvae import NsvaeEncoder
        from idccrn_vae_torch.models.vae import VaeDecoder

        U = self.U
        _, (tc, tdc) = self._configs(compute)
        x = torch.from_numpy(wav)
        if self.name == "supervised_fwd":
            model = load_jax_variables(
                SupervisedDccrn(tc, datanorm=v["dn"], device="cpu"),
                v["model"])
            with torch.no_grad():
                w, spec = model(x)
            return {"wav": U.to_np(w), "spec": U.to_np(spec)}
        enc = load_jax_variables(NsvaeEncoder(tc, device="cpu"),
                                 v["enc"]).state_dict()
        dec = load_jax_variables(VaeDecoder(tdc, device="cpu"),
                                 v["dec"]).state_dict()
        if self.name == "stream_chunk":
            port = StreamingEnhancer(tc, tdc, enc, dec,
                                     chunk_frames=STREAM_CHUNK_FRAMES,
                                     device="cpu")
            out, st = port.process_chunk(port.init_state(self.b), wav)
            return {"chunk": U.to_np(out),
                    **{f"state{i}": U.to_np(t)
                       for i, t in enumerate(_leaves(st))}}
        kw = dict(num_samples=1)
        noise = None
        if self.name == "dual_mask":
            kw.update(outtype="complex_mask", latent_to_use=2)
            noise = load_jax_variables(VaeDecoder(tdc, device="cpu"),
                                       v["noise"]).state_dict()
        port = tenh.Enhancer(tc, tdc, enc, dec, noise, device="cpu", **kw)
        out = U.to_np(port.forward(x))
        if self.name == "clean_direct":
            return {"wav": out}
        speech, noise, noisy = map(U.to_np, self.spectra["port"][-1])
        return {"speech_spec": speech, "noise_spec": noise,
                "noisy_spec": noisy, "wav": out}

    def _combined(self, want):
        """The port's mask combination and ISTFT of the JAX side's own
        spectra: the end of the dual program on shared inputs."""
        import torch

        from idccrn_vae_torch.eval.enhance import combine_outputs
        from idccrn_vae_torch.ops.stft import istft

        s, n, y = (torch.from_numpy(want[k]) for k in
                   ("speech_spec", "noise_spec", "noisy_spec"))
        out = istft(combine_outputs("complex_mask", s, n, y, 1), 512, 100,
                    400)
        return self.U.to_np(out)[:, :want["wav"].shape[1]]

    def outputs(self, seed):
        """(port, JAX) outputs of one seed, each {compute: {name:
        array}}."""
        v = self._variables(seed)
        self.draws.set(seed)
        n = (STREAM_CHUNK_FRAMES * 100 if self.name == "stream_chunk"
             else self.n)
        wav = self.U.wav_batch(200 + seed, self.b, n)
        got = {c: self._port(c, v, wav) for c in ("f32", "bf16")}
        want = {c: self._jax(c, v, wav) for c in ("f32", "bf16")}
        assert set(got["f32"]) == set(want["f32"]), self.name
        return got, want

    def run(self, seed, eager=False):
        """Both sides at f32 and bf16 for one seed -> (f32 record,
        yardstick rows). The dual program's complex_mask output S/(S+N)
        has no bound where S is close to -N (a few ulps in S and N move
        such a bin arbitrarily; tests/test_torch_port_dual.py): its two
        spectra are held end to end, the combination on shared inputs (the
        port's combination of JAX's spectra against JAX's output, F32_TOL
        at both computes: the masks run in float32), and the end-to-end
        waveform is reported, not held."""
        U = self.U
        got, want = self.outputs(seed)
        f32, extra = {}, {}
        if self.name == "dual_mask":
            for c in ("f32", "bf16"):
                f32[f"combined_{c}"] = _allclose_margin(
                    self._combined(want[c]), want[c]["wav"], **U.F32_TOL)
                extra[c] = {k: got[c].pop(k) for k in ("wav", "noisy_spec")}
                for k in ("wav", "noisy_spec"):
                    extra[c][f"jax_{k}"] = want[c].pop(k)
            f32["end_to_end_wav"] = _allclose_margin(
                extra["f32"]["wav"], extra["f32"]["jax_wav"], **U.F32_TOL)
            f32["end_to_end_bf16_dist"] = {
                "port": U.rel_dist(extra["bf16"]["wav"],
                                   extra["f32"]["jax_wav"]),
                "jax": U.rel_dist(extra["bf16"]["jax_wav"],
                                  extra["f32"]["jax_wav"])}
        f32["output"] = max(_allclose_margin(got["f32"][k], want["f32"][k],
                                             **U.F32_TOL)
                            for k in want["f32"])
        f32["ok"] = bool(max(v for k, v in f32.items()
                             if k == "output" or k.startswith("combined"))
                         <= 1)
        rows = U.yardstick({"outputs": got["bf16"]},
                           {"outputs": want["bf16"]},
                           {"outputs": want["f32"]})
        return f32, rows


def _leaves(state):
    """A StreamState -> its arrays in field order."""
    out = []
    for field in state:
        if isinstance(field, list):
            for item in field:
                out.extend(item if isinstance(item, tuple) else (item,))
        else:
            out.append(field)
    return out


# ---------------------------------------------------------------- report


def summarise(rows) -> dict:
    """The bf16 record of one case and seed: every loss, output and model
    row; the worst parameter on each side; the failures; and every row as
    [kind, name, port, JAX, f32 share of the model's update, ...] (`rows_of`
    rebuilds them for --rejudge; then a PReLU slope's expected bf16
    spread, else None, and a parameter's even share, else None)."""
    keep = [r for r in rows if r["kind"] in ("loss", "output", "model")]
    params = [r for r in rows if r["kind"] == "param"]
    shares = [r for r in rows if r["kind"] == "bias_share"]
    out = {"rows": {f"{r['kind']}:{r['name']}": _row(r) for r in keep}}
    if params:
        for side in ("port", "jax"):
            w = max(params, key=lambda r: r[side])
            out[f"worst_param_{side}"] = {"name": w["name"], **_row(w)}
        out["worst_param_of_bound"] = max(r["port"] / r["bound"]
                                          for r in params)
    if shares:
        out["bias_share_max"] = {s: max(r[s] for r in shares)
                                 for s in ("port", "jax")}
    out["fails"] = [{"kind": r["kind"], "name": r["name"], **_row(r)}
                    for r in rows if not r["ok"]]
    out["ok"] = not out["fails"]
    g = lambda v, d=5: None if v is None else float(f"{v:.{d}g}")
    out["all_rows"] = [[r["kind"], r["name"], g(r["port"]), g(r["jax"]),
                        g(r["share"], 4), g(r.get("spread"), 4),
                        g(r.get("even"), 4)]
                       for r in rows]
    return out


def rows_of(record) -> list:
    """A summarised record's rows, judged afresh by the yardstick's
    current rule (torch_port_util.judge_row)."""
    U = util()
    return [U.judge_row(dict(kind=k, name=n, port=p, jax=j, share=sh,
                             spread=sp, even=ev))
            for k, n, p, j, sh, sp, ev in record["all_rows"]]


def _row(r) -> dict:
    return {"port": r["port"], "jax": r["jax"],
            "ratio": r["port"] / r["jax"] if r["jax"] > 0 else None,
            "bound": r["bound"], "ok": r["ok"]}


def ratio_stats(all_rows) -> dict:
    """Over every case and seed, per kind: the rows, the largest
    port/JAX ratio among rows whose JAX distance is at least YARD_FLOOR
    (above the floor, where the ratio carries the yardstick), and the
    largest port distance over its bound."""
    U = util()
    out = {}
    for kind in ("loss", "output", "model", "param"):
        rows = [r for r in all_rows if r["kind"] == kind]
        if not rows:
            continue
        above = [r["port"] / r["jax"] for r in rows
                 if r["jax"] >= U.YARD_FLOOR]
        out[kind] = dict(rows=len(rows), above_floor=len(above),
                         ratio_max=max(above) if above else None,
                         ratio_min=min(above) if above else None,
                         of_bound_max=max(r["port"] / r["bound"]
                                          for r in rows))
    return out


def top_params(records) -> dict:
    """The TOP parameters furthest from f32 on each side, each at its
    worst seed: (case, parameter) -> distance."""
    out = {}
    for side in ("port", "jax"):
        worst = {}
        for case, seed, r in records:
            key = (case, r["name"])
            if key not in worst or r[side] > worst[key][1][side]:
                worst[key] = (seed, r)
        ranked = sorted(worst.items(), key=lambda kv: -kv[1][1][side])
        out[side] = [{"case": c, "param": n, "seed": s, "dist": r[side],
                      "other_side": r["jax" if side == "port" else "port"]}
                     for (c, n), (s, r) in ranked[:TOP]]
    return out


def rejudge(report) -> dict:
    """Every bf16 record of a written report judged afresh from its rows,
    and the report's summaries recomputed."""
    U = util()
    records, all_rows = [], []
    for name, case in report["cases"].items():
        for seed, rec in case.items():
            f32 = rec["f32"]
            if "models" in f32:
                for m in f32["models"].values():
                    judge_f32_model(U, m)
                f32["ok"] = f32_train_ok(f32)
            rows = rows_of(rec["bf16"])
            rec["bf16"] = summarise(rows)
            all_rows += rows
            records += [(name, int(seed), r) for r in rows
                        if r["kind"] == "param"]
    return finish(report, records, all_rows)


def finish(report, records, all_rows) -> dict:
    U = util()
    report["setting"].update(yard_ratio=U.YARD_RATIO,
                             param_ratio=U.PARAM_RATIO,
                             yard_floor=U.YARD_FLOOR, spread_k=U.SPREAD_K)
    report["ratio_stats"] = ratio_stats(all_rows)
    report["top_params"] = top_params(records)
    report["f32_ok"] = all(s["f32"]["ok"] for c in report["cases"].values()
                           for s in c.values())
    report["bf16_ok"] = all(s["bf16"]["ok"] for c in report["cases"].values()
                            for s in c.values())
    report["verdict"] = "MATCH" if report["f32_ok"] and report["bf16_ok"] \
        else "MISMATCH"
    return report


def run(seeds, cases, b, n, eager=(), progress=print) -> dict:
    import pytest
    import torch

    U = util()
    report = {"setting": {
        "geometry": "reference: DccrnConfig() widths (channels "
                    "1-32-64-128-128-256-256, zdim 128, LSTM hidden 128), "
                    "default StftConfig (n_fft 512, hop 100, win 400)",
        "seeds": list(seeds), "batch": b, "samples": n,
        "frames": n // 100 + 1, "torch_threads": torch.get_num_threads(),
        "jax_prelu": "slope cotangent summed in float32 "
                     "(torch_port_util.f32_slope_prelu)",
        "cuts": [f"batch: the inis' {sorted(set(INI_BATCH.values()))} "
                 f"-> {b}",
                 f"segment: {INI_FRAMES} frames -> {n // 100 + 1} "
                 f"({n} samples)",
                 "pretraining num_samples 5 (the ini's usage line) -> 2 "
                 "(the suite's recipe)",
                 f"serving: B {b}, {n} samples (the stream: one chunk of "
                 f"{STREAM_CHUNK_FRAMES} frames)"]},
        "cases": {}, "seconds": {}}
    records, all_rows = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("idccrn_vae_tpu.models.modules.prelu",
                   U.f32_slope_prelu())
        for name in cases:
            t0 = time.perf_counter()
            draws = U.SeededDraws()
            cls = TrainCase if name in TRAIN_CASES else ServeCase
            case = cls(U, mp, draws, name, b, n)
            draws.install(mp)
            rec = report["cases"][name] = {}
            for seed in seeds:
                t1 = time.perf_counter()
                f32, rows = case.run(seed, eager=(name in eager
                                                  and seed == seeds[0]))
                all_rows += rows
                records += [(name, seed, r) for r in rows
                            if r["kind"] == "param"]
                rec[str(seed)] = {"f32": f32, "bf16": summarise(rows),
                                  "seconds": time.perf_counter() - t1}
                progress(f"{name} seed {seed}: f32 ok {f32['ok']}, bf16 ok "
                         f"{rec[str(seed)]['bf16']['ok']} "
                         f"({rec[str(seed)]['seconds']:.1f} s)")
            del case
            report["seconds"][name] = time.perf_counter() - t0
    return finish(report, records, all_rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", default="0,1,2,3,4")
    p.add_argument("--cases", default=",".join(TRAIN_CASES + SERVE_CASES))
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--samples", type=int, default=8000)
    p.add_argument("--jax-eager", default="pretrain_zero,supervised",
                   help="train cases whose JAX f32 step also runs op by op "
                        "at the first seed (JAX's own f32 spread)")
    p.add_argument("--out", default=os.path.join(
        REPO, "FULLWIDTH_PARITY_TORCH.json"))
    p.add_argument("--rejudge", default=None, metavar="REPORT",
                   help="judge a written report's rows afresh and write it "
                        "to --out, running nothing")
    args = p.parse_args(argv)
    if args.rejudge:
        with open(args.rejudge) as f:
            report = rejudge(json.load(f))
    else:
        t0, c0 = time.perf_counter(), time.process_time()
        report = run([int(s) for s in args.seeds.split(",")],
                     args.cases.split(","), args.batch, args.samples,
                     eager=tuple(filter(None, args.jax_eager.split(","))))
        report["wall_s"] = time.perf_counter() - t0
        report["cpu_s"] = time.process_time() - c0
        report["host"] = {"cpus": len(os.sched_getaffinity(0))}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in ("verdict", "f32_ok", "bf16_ok",
                                             "wall_s", "ratio_stats")},
                     indent=1))
    print(f"report: {args.out}")
    return report


if __name__ == "__main__":
    main()
