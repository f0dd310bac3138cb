"""Whole-recipe trajectory parity: the JAX package against the port, with
the same weights, corpus and random draws, stage by stage.

The E2E's stages in the E2E's order (`idccrn_vae_torch/tools/e2e_train.py`,
`tools/e2e_train_tpu.py`): CVAE and NVAE pretraining, NSVAE posterior
matching, phase 2 classical and adversarial, the supervised DCCRN; then
the evaluation of each leg: `test_enhance --phase 2` of both phase-2 runs,
the phase-1 latent_num 2 program through its four out-types, and
`test_supervised`. Each stage runs through both packages' training CLIs
in this process, with the E2E's ini text and flags, so each side chains
its own checkpoints from stage to stage (the port's NSVAE starts from the
port's CVAE and NVAE) and divergence compounds as it does in the E2E.

The same inputs on both sides:
  * weights: every model a stage initialises fresh gets the JAX
    trainer's init (`init_state`), loaded into the port's trainer
    through `models/from_jax.load_jax_variables` before its `fit`; the
    models a stage takes from an earlier one come from each side's own
    checkpoints;
  * corpus: one `data/synth.make_corpus` corpus (the E2E recipe, 6.5 s
    utterances) read by both loaders, whose numpy shuffles are the same;
  * draws: every latent draw, in training, validation and evaluation,
    comes from `SharedDraws`, which names it by (stage, split, epoch,
    step, model, latent slot) and draws it from a numpy generator seeded
    by that name. The draws are aligned by name, not by call order: the
    JAX adversarial phase-2 step encodes a D-update batch twice with one
    key and the port once, and both passes see the same draw. JAX's
    draws are fetched at run time (`jax.pure_callback`), so a jitted step
    gets new draws each step without retracing. No other draw is made on
    these paths: the E2E uses no 'prob' skip coin, the MI term (off in the
    E2E) and the Discriminator draw nothing.

What is compared, per stage and epoch: every train and val loss
component; the KL weight each split applied; the learning rate after
each epoch; the epochs that improved the best val loss (hence the best
epoch) and the epoch training stopped at. Discrete decisions must be
equal. A loss component passes at a stage's epoch e when

  |port - jax| <= MAX_REL * max(|jax|, FLOOR) * (1 + n),
  n = e + the epochs of the stages whose checkpoints the stage starts
      from, along the longest chain (UPSTREAM)

MAX_REL = 5e-3 is the JAX tool's f32 bound for a loop of ~50 steps
(tools/trajectory_parity.py): f32 rounding differences of one step
(the suite holds single steps to 5e-3 relative) feed the next through
the weights and, within an epoch, average out in the epoch mean; across
epochs they add, so the bound grows by one MAX_REL per epoch of training
behind the weights. A chained stage starts from checkpoints that already
differ by their own stages' epochs (the NSVAE's frozen targets are each
side's CVAE and NVAE), so those epochs count too; the stage-local bound
(n = e) is reported beside it. FLOOR = 1e-3 keeps components near zero
(a KL under warm-up) from dividing by nothing. The bf16 run gets no
bound: it records the first epoch at which a component differs by more
than 2%. `--rejudge REPORT` recomputes the comparisons of a written
report.

For the evaluation both packages' runners score the val split: per
utterance SI-SDR, ESTOI and PESQ-WB, and each leg's mean delta against
the noisy input. The ESTOI deltas must agree within 0.04, the
resolution of ROADMAP queue 3's item.

  python -m port_tools.trajectory_parity --geometry tiny --n-train 8 \
      --n-val 8 --epochs-scale 0.12

writes TRAJECTORY_PARITY_TORCH.json (or --out): the geometry, every cut
from the E2E's sizes, both sides' curves, the largest relative gap per
epoch, and the first stage, epoch and step at which a bound fails. It
needs JAX and both packages, so it runs on the CPU of a machine that has
both; the port runs with `--device cpu`.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 16000
MAX_REL = 5e-3
FLOOR = 1e-3
BF16_FLAG = 2e-2
ESTOI_TOL = 0.04
METRICS = ("sisdr", "estoi", "pesq")
TRAIN_STAGES = ("cvae", "nvae", "nsvae", "p2", "p2adv", "sup")
OUTTYPES = ("clean_direct", "real_imag_mask", "complex_mask", "phase_mask")
EVALS = ("eval", "evaladv") + tuple(f"evalp1_{o}" for o in OUTTYPES) \
    + ("evalsup",)
# the stages whose checkpoints a stage starts from (the E2E's chain:
# phase 2 takes the NSVAE's encoder and the CVAE's decoder)
UPSTREAM = {"cvae": (), "nvae": (), "nsvae": ("cvae", "nvae"),
            "p2": ("nsvae", "cvae"), "p2adv": ("nsvae", "cvae"), "sup": ()}
# E2E sizes (idccrn_vae_torch/tools/e2e_train.py)
E2E = dict(n_train=96, n_val=104, encoder_dim_start=32, zdim=128,
           compute="bf16", epochs={"cvae": 30, "nvae": 30, "nsvae": 25,
                                   "p2": 25, "p2adv": 25, "sup": 25},
           kl_warm_epochs=10)
# the E2E's STFT, segments and utterances, and the tests' tiny ones
# (tests/torch_port_util.py TINY_STFT): each CLI reads them from its ini
REFERENCE_FRAMES = dict(winlen=400, nfft=512, hopfrac=100, sequence_len=481,
                        utt_seconds=6.5)
GEOMETRIES = {"tiny": dict(encoder_dim_start=2, zdim=4, winlen=16, nfft=32,
                           hopfrac=8, sequence_len=100, utt_seconds=0.5),
              "reference": dict(encoder_dim_start=32, zdim=128,
                                **REFERENCE_FRAMES)}
E2E.update(REFERENCE_FRAMES)


# ------------------------------------------------------------------ draws


class SharedDraws:
    """Latent draws named by where they are made, the same on both sides.

    `tick` is (stage, split, epoch, step), set around each train step,
    val step and evaluation batch; `scope` is the model whose forward is
    running and the count of draws it made so far in that forward. A
    draw's name is (seed, *tick, model, slot); its values come from a
    numpy generator seeded by a hash of the name."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.tick = None
        self.scope: List[list] = []
        self.counts: Dict[tuple, int] = {}
        self.epoch = None

    def next_slot(self):
        """(model, slot) of the next draw of the running forward."""
        if not self.scope:
            raise RuntimeError("a latent draw outside a named model")
        entry = self.scope[-1]
        entry[1] += 1
        return entry[0], entry[1] - 1

    def eps(self, name, shape):
        if self.tick is None:
            raise RuntimeError(f"draw {name} outside a step")
        key = repr((self.seed, *self.tick, *name)).encode()
        rng = np.random.default_rng(
            int.from_bytes(hashlib.sha256(key).digest()[:8], "little"))
        return tuple(rng.standard_normal(shape).astype(np.float32)
                     for _ in range(2))

    def start(self, stage, split, epoch):
        key = (stage, split, int(epoch))
        i = self.counts.get(key, 0)
        self.counts[key] = i + 1
        self.tick = key + (i,)
        self.epoch = int(epoch)


class Log:
    """What one side's stage did: curves, learning rates, KL weights,
    improvements."""

    def __init__(self):
        self.curves = None
        self.lr: Dict[int, list] = {}
        self.kl: Dict[str, Dict[int, float]] = {"train": {}, "val": {}}
        self.improved: List[int] = []

    def as_dict(self):
        return {"curves": self.curves,
                "lr": [self.lr[k] for k in sorted(self.lr)],
                "kl_weight": {s: [v[e] for e in sorted(v)]
                              for s, v in self.kl.items() if v},
                "improved_epochs": self.improved,
                "best_epoch": self.improved[-1] if self.improved else None,
                "epochs_run": len(self.curves["val"]) if self.curves
                else 0}


# -------------------------------------------------------------- patching

# class of a trainer or enhancer (both packages) -> {attribute holding a
# model whose forward draws: the name of its draws}; the port's NSVAE
# trainer holds its encoders in `models` under those names
_DRAWERS = {"PretrainTrainer": {"encoder": "enc"},
            "NsvaeTrainer": {"clean_enc": "clean_enc",
                             "noise_enc": "noise_enc",
                             "noisy_enc": "noisy_enc"},
            "Phase2Trainer": {"encoder": "encoder"},
            "SupervisedTrainer": {},
            "Enhancer": {"encoder": "encoder"}}
_TRAINERS = (("pretrain", "PretrainTrainer"), ("nsvae", "NsvaeTrainer"),
             ("phase2", "Phase2Trainer"), ("supervised", "SupervisedTrainer"))


def _jax_models(trainer_name: str, state) -> Dict[str, dict]:
    """The model variables of a JAX trainer state, by the port's names."""
    if trainer_name == "PretrainTrainer":
        return {"enc": state["enc"], "dec": state["dec"]}
    if trainer_name == "SupervisedTrainer":
        return {"model": state["model"]}
    return dict(state["models"])


class SharedRun:
    """Installs the patches of both packages that give them the same
    draws and record what their trainers do. `stage` names the stage
    (or evaluation leg) running; `side` is 'jax' or 'port'."""

    def __init__(self, draws: SharedDraws):
        self.draws = draws
        self.stage = None
        self.side = None
        self.logs: Dict[str, Dict[str, Log]] = {}
        self.jax_init: Dict[str, Dict[str, dict]] = {}

    def log(self) -> Log:
        return self.logs.setdefault(self.stage, {}).setdefault(self.side,
                                                               Log())

    @contextlib.contextmanager
    def running(self, stage: str, side: str):
        """Inside the block, what runs is `side`'s `stage`; each side
        counts its steps from 0."""
        self.stage, self.side = stage, side
        self.draws.counts = {}
        try:
            yield self.log()
        finally:
            self.stage = self.side = None

    def compare(self, stage: str, bounded: bool = True) -> dict:
        """`compare_stage` of both sides' logs of `stage`."""
        logs = self.logs[stage]
        return compare_stage(logs["jax"].as_dict(), logs["port"].as_dict(),
                             bounded)

    # -- model scopes -----------------------------------------------------

    def _scoped(self, fn, name):
        draws = self.draws

        def call(*args, **kwargs):
            draws.scope.append([name, 0])
            try:
                return fn(*args, **kwargs)
            finally:
                draws.scope.pop()

        return call

    def _name_models(self, obj, side):
        for attr, name in _DRAWERS[type(obj).__name__].items():
            if side == "jax":
                m = getattr(obj, attr)
                m.apply = self._scoped(m.apply, name)
            else:
                m = (obj.models[name] if hasattr(obj, "models")
                     and not hasattr(obj, attr) else getattr(obj, attr))
                m.forward = self._scoped(m.forward, name)

    # -- steps ------------------------------------------------------------

    def _stepper(self, orig, split, sync):
        run = self

        def step(obj, *args, **kwargs):
            run.draws.start(run.stage, split, args[-1])
            try:
                out = orig(obj, *args, **kwargs)
                sync(out)
                return out
            finally:
                run.draws.tick = None

        return step

    def _batcher(self, orig):
        run = self

        def enhance_batch(obj, *args, **kwargs):
            run.draws.start(run.stage, "eval", 0)
            try:
                return orig(obj, *args, **kwargs)
            finally:
                run.draws.tick = None

        return enhance_batch

    # -- install ----------------------------------------------------------

    @contextlib.contextmanager
    def installed(self):
        import jax
        import jax.numpy as jnp
        import torch

        import idccrn_vae_torch.eval.enhance as t_enhance
        import idccrn_vae_torch.losses.vae_loss as t_vae_loss
        import idccrn_vae_torch.models.nsvae as t_nsvae
        import idccrn_vae_torch.models.vae as t_vae
        import idccrn_vae_torch.train.checkpoint as t_ckpt
        import idccrn_vae_torch.train.optim as t_optim
        import idccrn_vae_tpu.eval.enhance as j_enhance
        import idccrn_vae_tpu.losses.vae_loss as j_vae_loss
        import idccrn_vae_tpu.models.nsvae as j_nsvae
        import idccrn_vae_tpu.models.vae as j_vae
        import idccrn_vae_tpu.train.checkpoint as j_ckpt
        import idccrn_vae_tpu.train.optim as j_optim
        from idccrn_vae_torch.models.from_jax import load_jax_variables

        run, draws = self, self.draws
        saved = []

        def patch(obj, attr, value):
            saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, value)

        # latent draws
        j_reparam = j_vae.reparameterize
        t_reparam = t_vae.reparameterize

        def jax_reparam(rng, g, num_samples, guard="eps", noise=None):
            name = draws.next_slot()
            shape = (g.mu_r.shape[0], num_samples, *g.mu_r.shape[1:])
            e = jax.pure_callback(
                lambda: np.stack(draws.eps(name, shape)),
                jax.ShapeDtypeStruct((2, *shape), jnp.float32))
            e = e.astype(g.mu_r.dtype)
            return j_reparam(rng, g, num_samples, guard=guard,
                             noise=(e[0], e[1]))

        def port_reparam(g, num_samples, guard="eps", noise=None,
                         generator=None):
            name = draws.next_slot()
            shape = (g.mu_r.shape[0], num_samples, *g.mu_r.shape[1:])
            er, ei = draws.eps(name, shape)
            return t_reparam(g, num_samples, guard=guard,
                             noise=(torch.from_numpy(er),
                                    torch.from_numpy(ei)))

        for mod in (j_vae, j_nsvae):
            patch(mod, "reparameterize", jax_reparam)
        for mod in (t_vae, t_nsvae):
            patch(mod, "reparameterize", port_reparam)

        # trainers: steps, names, weights, curves
        import importlib

        for module, cls_name in _TRAINERS:
            jcls = getattr(importlib.import_module(
                f"idccrn_vae_tpu.train.{module}"), cls_name)
            tcls = getattr(importlib.import_module(
                f"idccrn_vae_torch.train.{module}"), cls_name)
            for cls, side, sync in ((jcls, "jax", jax.block_until_ready),
                                    (tcls, "port", lambda out: None)):
                patch(cls, "train_step",
                      self._stepper(cls.train_step, "train", sync))
                patch(cls, "eval_step",
                      self._stepper(cls.eval_step, "val", sync))
                patch(cls, "__init__", self._init_wrapper(cls.__init__,
                                                          side))
            patch(jcls, "init_state", self._capture_init(jcls.init_state,
                                                         cls_name))
            patch(jcls, "fit", self._fit_wrapper(jcls.fit, "jax", None))
            patch(tcls, "fit", self._fit_wrapper(tcls.fit, "port",
                                                 load_jax_variables))
        for cls, side in ((j_enhance.Enhancer, "jax"),
                          (t_enhance.Enhancer, "port")):
            patch(cls, "__init__", self._init_wrapper(cls.__init__, side))
            patch(cls, "enhance_batch", self._batcher(cls.enhance_batch))

        # learning rates, KL weights, improvements
        def sched_wrapper(orig, lr_of):
            def step(sched, metric, opt):
                out = orig(sched, metric, opt)
                lr = lr_of(out[0] if isinstance(out, tuple) else opt)
                lrs = run.log().lr.setdefault(draws.epoch, [])
                lrs.append(float(lr))
                return out

            return step

        patch(j_optim.PlateauScheduler, "step",
              sched_wrapper(j_optim.PlateauScheduler.step,
                            j_optim.get_learning_rate))
        patch(t_optim.PlateauScheduler, "step",
              sched_wrapper(t_optim.PlateauScheduler.step,
                            t_optim.get_learning_rate))

        def kl_wrapper(orig):
            def kl_weight_at(loss, epoch):
                w = orig(loss, epoch)
                if draws.tick is not None:
                    split = draws.tick[1]
                    run.log().kl[split][draws.epoch] = float(w)
                return w

            return kl_weight_at

        for mod in (j_vae_loss, t_vae_loss):
            patch(mod.PretrainVaeLoss, "kl_weight_at",
                  kl_wrapper(mod.PretrainVaeLoss.kl_weight_at))

        def best_wrapper(orig):
            def save_best(ckpt, *args, **kwargs):
                run.log().improved.append(draws.epoch)
                return orig(ckpt, *args, **kwargs)

            return save_best

        for mod in (j_ckpt, t_ckpt):
            patch(mod.CheckpointManager, "save_best",
                  best_wrapper(mod.CheckpointManager.save_best))
        try:
            yield self
        finally:
            for obj, attr, value in reversed(saved):
                setattr(obj, attr, value)

    def _init_wrapper(self, orig, side):
        run = self

        def __init__(obj, *args, **kwargs):
            orig(obj, *args, **kwargs)
            run._name_models(obj, side)

        return __init__

    def _capture_init(self, orig, cls_name):
        run = self

        def init_state(obj, *args, **kwargs):
            state = orig(obj, *args, **kwargs)
            pretrained = kwargs.get("pretrained") or {}
            fresh = {k: v for k, v in _jax_models(cls_name, state).items()
                     if k not in pretrained}
            import jax

            run.jax_init[run.stage] = jax.tree.map(np.asarray, fresh)
            return state

        return init_state

    def _fit_wrapper(self, orig, side, load):
        run = self

        def fit(obj, *args, **kwargs):
            log = run.log()
            if side == "port":
                fresh = run.jax_init[run.stage]
                pretrained = set(kwargs.get("pretrained") or {})
                if set(fresh) | pretrained != set(obj.models):
                    raise RuntimeError(
                        f"{run.stage}: JAX initialises {sorted(fresh)} and "
                        f"the port loads {sorted(pretrained)}, the port "
                        f"has {sorted(obj.models)}")
                for name, variables in fresh.items():
                    load(obj.models[name], variables)
            out = orig(obj, *args, **kwargs)
            curves = out[1] if side == "jax" else out[0]
            log.curves = {s: [{k: float(v) for k, v in row.items()}
                              for row in curves[s]] for s in curves}
            return out

        return fit


# -------------------------------------------------------------- the recipe


def _clis(side):
    import importlib

    pkg = "idccrn_vae_tpu" if side == "jax" else "idccrn_vae_torch"
    return {name: importlib.import_module(f"{pkg}.cli.{name}").main
            for name in ("train_vae", "train_nsvae", "train_phase2",
                         "train_supervised", "test_enhance",
                         "test_supervised")}


def _ini_writer(geo):
    """The E2E's `write_ini` with `geo`'s STFT and segment length."""
    from idccrn_vae_torch.tools import e2e_train

    def write_ini(*args, **kwargs):
        path = e2e_train.write_ini(*args, **kwargs)
        with open(path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            key = line.split(" = ")[0]
            if key in REFERENCE_FRAMES:
                lines[i] = f"{key} = {geo[key]}"
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    return write_ini


def stage_argv(stage, root, dirs, geo, epochs, kl_warm):
    """The E2E's CLI arguments of a training stage, at `geo`'s widths."""
    from idccrn_vae_torch.tools.e2e_train import latest

    write_ini = _ini_writer(geo)

    common = ["--causal", "--compute", geo["compute"],
              "--first_use_dataset", "--n_devices", "1",
              "--encoder_dim_start", str(geo["encoder_dim_start"]),
              "--zdim", str(geo["zdim"])]
    e = epochs[stage]
    if stage in ("cvae", "nvae"):
        model = {"cvae": "complex_CVAE", "nvae": "complex_NVAE"}[stage]
        return "train_vae", [
            "--cfg_file", write_ini(root, dirs, stage, model, 16, e),
            *common, "--skip_padding", "--kl_ann_flag", "--kl_warm_epochs",
            str(kl_warm), "--kl_weight", "0.01"]
    if stage == "nsvae":
        return "train_nsvae", [
            "--cfg_file", write_ini(
                root, dirs, "nsvae", "complex_NSVAE", 16, e,
                extra=(f"pre_clean_encoder = {latest(root, 'cvae')}\n"
                       f"pre_noise_encoder = {latest(root, 'nvae')}\n")),
            *common, "--nsvae_model", "original", "--latent_num", "2",
            "--alpha", "1.0", "--w_kl", "1.0", "--w_dismiu", "0.1"]
    if stage in ("p2", "p2adv"):
        adv = stage == "p2adv"
        argv = ["--cfg_file", write_ini(
            root, dirs, stage,
            "phase2_adversarial" if adv else "phase2_classical",
            15 if adv else 14, e),
            *common, "--first_phase_folder", latest(root, "nsvae"),
            "--use_sc_phase2", "--recon_type", "mask", "--latent_num", "1"]
        if adv:
            argv += ["--adversarial", "--dlr", "1e-4", "--d_step", "3"]
        return "train_phase2", argv
    return "train_supervised", [
        "--cfg_file", write_ini(root, dirs, "sup", "supervised_DCCRN", 16,
                                e),
        *common, "--recon_type", "mask"]


def eval_argv(leg, root, dirs, compute):
    """The E2E's evaluation arguments of a leg -> (cli, argv, out dir)."""
    from idccrn_vae_torch.tools.e2e_train import latest

    meta = os.path.join(os.path.dirname(dirs["noisy_val"]),
                        "corpus_meta.json")
    data = ["--noisy_dir", dirs["noisy_val"], "--clean_dir",
            dirs["clean_val"]]
    out = os.path.join(root, f"out_{leg}")
    if leg == "evalsup":
        return "test_supervised", ["--model_dir", latest(root, "sup"),
                                   *data, "--out_dir", out,
                                   "--batch_size", "12"], out
    flags = [*data, "--out_dir", out, "--num_samples", "10",
             "--batch_size", "12", "--compute", compute,
             "--corpus_meta", meta]
    if leg in ("eval", "evaladv"):
        run = "p2" if leg == "eval" else "p2adv"
        return "test_enhance", ["--nsvae_dir", latest(root, run),
                                "--phase", "2", *flags], out
    outtype = leg[len("evalp1_"):]
    return "test_enhance", [
        "--nsvae_dir", latest(root, "nsvae"), "--phase", "1",
        "--decoder_dir", latest(root, "cvae"),
        "--noise_decoder_dir", latest(root, "nvae"),
        "--latent_to_use", "2", "--outtype", outtype, *flags], out


# ------------------------------------------------------------ comparisons


def compare_stage(jax_log: dict, port_log: dict, bounded: bool,
                  epochs_before: int = 0) -> dict:
    """Discrete decisions and per-epoch loss gaps of one stage whose
    starting weights have `epochs_before` epochs of training behind them
    (its upstream chain, `UPSTREAM`); `first_fail_stage_local` is the
    first failure of the bound that ignores them."""
    out = {"lr_match": len(jax_log["lr"]) == len(port_log["lr"]) and all(
        np.allclose(a, b, rtol=1e-6) for a, b in zip(jax_log["lr"],
                                                     port_log["lr"])),
        "kl_weight_match": jax_log["kl_weight"].keys()
        == port_log["kl_weight"].keys() and all(
            np.allclose(jax_log["kl_weight"][s], port_log["kl_weight"][s],
                        atol=1e-7, rtol=0)
            for s in jax_log["kl_weight"]),
        "improved_match": jax_log["improved_epochs"]
        == port_log["improved_epochs"],
        "epochs_run_match": jax_log["epochs_run"] == port_log["epochs_run"],
        "epochs_before": epochs_before}
    gaps, fails, first_2pct = [], {}, None
    jc, tc = jax_log["curves"], port_log["curves"]
    for e in range(min(len(jc["val"]), len(tc["val"]))):
        row = {}
        for split in ("train", "val"):
            a, b = jc[split][e], tc[split][e]
            if sorted(a) != sorted(b):
                raise ValueError(f"epoch {e} {split}: keys {sorted(a)} "
                                 f"against {sorted(b)}")
            for k in a:
                row[f"{split}.{k}"] = abs(b[k] - a[k]) / max(abs(a[k]),
                                                             FLOOR)
        worst = max(row, key=row.get)
        gaps.append({"epoch": e, "max_rel": row[worst], "at": worst,
                     "train_max_rel": max(v for k, v in row.items()
                                          if k.startswith("train.")),
                     "val_max_rel": max(v for k, v in row.items()
                                        if k.startswith("val."))})
        for key, n in (("chained", epochs_before + e),
                       ("stage_local", e)):
            bound = MAX_REL * (1 + n)
            if key not in fails and row[worst] > bound:
                fails[key] = {"epoch": e, "component": worst,
                              "rel": row[worst], "bound": bound}
        if first_2pct is None and row[worst] > BF16_FLAG:
            first_2pct = {"epoch": e, "component": worst, "rel": row[worst]}
    out["per_epoch"] = gaps
    out["first_over_2pct"] = first_2pct
    discrete = all(out[k] for k in ("lr_match", "kl_weight_match",
                                    "improved_match", "epochs_run_match"))
    first_fail = fails.get("chained")
    out["first_fail"] = first_fail if bounded else None
    out["first_fail_stage_local"] = (fails.get("stage_local") if bounded
                                     else None)
    out["ok"] = discrete and (first_fail is None or not bounded)
    return out


def epochs_before(stage: str, stages: dict) -> int:
    """Epochs of training behind a stage's starting weights: the longest
    chain of upstream stages (`UPSTREAM`) among those run."""
    return max((epochs_before(u, stages) + stages[u]["jax"]["epochs_run"]
                for u in UPSTREAM[stage] if u in stages), default=0)


def judge(report: dict) -> dict:
    """(Re)compute each stage's comparison, the first failure and the
    verdict from the curves and evaluation comparisons in `report`."""
    bounded = report["geometry"]["compute"] == "f32"
    first = None
    for stage, entry in report["stages"].items():
        cmp = compare_stage(entry["jax"], entry["port"], bounded,
                            epochs_before(stage, report["stages"]))
        entry["compare"] = cmp
        if first is None and not cmp["ok"]:
            ff = cmp["first_fail"] or {}
            first = {"stage": stage, "epoch": ff.get("epoch"),
                     "component": ff.get("component"),
                     "discrete": {k: cmp[k] for k in (
                         "lr_match", "kl_weight_match", "improved_match",
                         "epochs_run_match")}}
    report["first_failure"] = first
    report["estoi_deltas_within"] = all(
        e["estoi_delta_ok"] is not False for e in report["evals"].values())
    report["verdict"] = ("MATCH" if first is None
                         and report["estoi_deltas_within"] else "MISMATCH")
    report["bound"] = {
        "loss": (f"|port - jax| <= {MAX_REL} * max(|jax|, {FLOOR}) * "
                 "(1 + n), n = epochs of training behind the weights "
                 "(the stage's earlier epochs and its upstream chain)")
        if bounded else f"none; first epoch over {BF16_FLAG} kept",
        "estoi_delta": ESTOI_TOL}
    return report


def _read(path):
    with open(path) as f:
        return json.load(f)


def compare_eval(jax_out: str, port_out: str, noisy_jax: Optional[str],
                 noisy_port: Optional[str]) -> dict:
    """Per-utterance metric gaps and mean deltas against the noisy input
    of one evaluation leg; the noisy scores come from the dirs given, for
    the supervised leg the phase-2 leg's (without them, no deltas)."""
    jp = _read(os.path.join(jax_out, "per_utterance.json"))
    tp = _read(os.path.join(port_out, "per_utterance.json"))
    jn = _read(os.path.join(noisy_jax, "noisy_per_utterance.json")) \
        if noisy_jax else None
    tn = _read(os.path.join(noisy_port, "noisy_per_utterance.json")) \
        if noisy_port else None
    if sorted(jp) != sorted(tp):
        raise ValueError("the two runs scored different utterances")
    names = sorted(jp)
    rep = {"utterances": len(names)}
    for m in METRICS:
        j = np.asarray([jp[u][m] for u in names])
        t = np.asarray([tp[u][m] for u in names])
        rep[m] = {"max_abs_diff": float(np.abs(t - j).max()),
                  "mean_jax": float(j.mean()), "mean_port": float(t.mean())}
        if jn is not None:
            dj = float(np.mean(j - np.asarray([jn[u][m] for u in names])))
            dt = float(np.mean(t - np.asarray([tn[u][m] for u in names])))
            rep[m].update(delta_jax=dj, delta_port=dt, delta_diff=dt - dj)
    rep["estoi_delta_ok"] = (None if jn is None else
                             abs(rep["estoi"]["delta_diff"]) <= ESTOI_TOL)
    return rep


# ------------------------------------------------------------------- runs


def run(root: str, geometry: str, epochs_scale: float, n_train: int,
        n_val: int, compute: str = "f32", seed: int = 0,
        encoder_dim_start: Optional[int] = None, zdim: Optional[int] = None,
        evals=EVALS, stages=TRAIN_STAGES, progress=print) -> dict:
    """Both packages through the recipe; returns the report."""
    import jax

    from idccrn_vae_torch.data.synth import make_corpus

    jax.config.update("jax_platforms", "cpu")
    geo = dict(GEOMETRIES[geometry], compute=compute)
    if encoder_dim_start:
        geo["encoder_dim_start"] = encoder_dim_start
    if zdim:
        geo["zdim"] = zdim
    epochs = {s: max(2, int(e * epochs_scale))
              for s, e in E2E["epochs"].items()}
    kl_warm = max(1, int(E2E["kl_warm_epochs"] * epochs_scale))
    os.makedirs(root, exist_ok=True)
    dirs, _ = make_corpus(os.path.join(root, "corpus"), n_train, n_val,
                          geo["utt_seconds"], FS)
    roots = {s: os.path.join(root, s) for s in ("jax", "port")}
    for d in roots.values():
        os.makedirs(d, exist_ok=True)
    clis = {s: _clis(s) for s in roots}
    shared = SharedRun(SharedDraws(seed))
    walls: Dict[str, Dict[str, float]] = {}

    def one(stage, side, cli, argv):
        os.environ["IDCCRN_CACHE_DIR"] = roots[side]
        argv = argv + (["--device", "cpu"] if side == "port" else [])
        t0 = time.perf_counter()
        with shared.running(stage, side):
            clis[side][cli](argv)
        walls.setdefault(stage, {})[side] = time.perf_counter() - t0
        progress(f"{stage} {side}: {walls[stage][side]:.1f} s")

    prev_cache = os.environ.get("IDCCRN_CACHE_DIR")
    try:
        with shared.installed():
            for stage in stages:
                for side in ("jax", "port"):
                    cli, argv = stage_argv(stage, roots[side], dirs, geo,
                                           epochs, kl_warm)
                    one(stage, side, cli, argv)
            outs = {}
            for leg in evals:
                for side in ("jax", "port"):
                    cli, argv, out = eval_argv(leg, roots[side], dirs,
                                               compute)
                    outs.setdefault(leg, {})[side] = out
                    one(leg, side, cli, argv)
    finally:
        if prev_cache is None:
            os.environ.pop("IDCCRN_CACHE_DIR", None)
        else:
            os.environ["IDCCRN_CACHE_DIR"] = prev_cache

    report = {
        "geometry": {**geo, "geometry": geometry, "causal": True,
                     "fs": FS, "train_utts": n_train, "val_utts": n_val,
                     "epochs": epochs, "kl_warm_epochs": kl_warm,
                     "batches": {"cvae": 16, "nvae": 16, "nsvae": 16,
                                 "p2": 14, "p2adv": 15, "sup": 16,
                                 "eval": 12},
                     "eval_num_samples": 10, "seed": seed},
        "cuts": cuts_from_e2e(geo, epochs, kl_warm, n_train, n_val),
        "stages": {stage: {s: shared.logs[stage][s].as_dict()
                           for s in ("jax", "port")} for stage in stages},
        "evals": {}, "seconds": walls}
    for leg in evals:
        noisy = {"jax": None, "port": None} if leg == "evalsup" else \
            outs[leg]
        if leg == "evalsup" and "eval" in outs:
            noisy = outs["eval"]
        report["evals"][leg] = compare_eval(outs[leg]["jax"],
                                            outs[leg]["port"],
                                            noisy["jax"], noisy["port"])
    return judge(report)


def cuts_from_e2e(geo, epochs, kl_warm, n_train, n_val) -> List[str]:
    cuts = []
    for k in ("encoder_dim_start", "zdim", "compute", *REFERENCE_FRAMES):
        if geo[k] != E2E[k]:
            cuts.append(f"{k} {E2E[k]} -> {geo[k]}")
    if n_train != E2E["n_train"]:
        cuts.append(f"train utterances {E2E['n_train']} -> {n_train}")
    if n_val != E2E["n_val"]:
        cuts.append(f"val utterances {E2E['n_val']} -> {n_val}")
    for s, e in epochs.items():
        if e != E2E["epochs"][s]:
            cuts.append(f"{s} epochs {E2E['epochs'][s]} -> {e} "
                        "(early-stop patience = epochs, as the E2E)")
    if kl_warm != E2E["kl_warm_epochs"]:
        cuts.append(f"KL warm-up epochs {E2E['kl_warm_epochs']} -> "
                    f"{kl_warm}")
    cuts.append("--n_devices 1 on both sides (one JAX device, no "
                "process group)")
    return cuts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--geometry", choices=sorted(GEOMETRIES),
                   default="tiny")
    p.add_argument("--encoder-dim-start", type=int, default=None,
                   help="override the geometry's first channel width")
    p.add_argument("--zdim", type=int, default=None,
                   help="override the geometry's latent width")
    p.add_argument("--epochs-scale", type=float, default=0.12)
    p.add_argument("--n-train", type=int, default=E2E["n_train"])
    p.add_argument("--n-val", type=int, default=E2E["n_val"])
    p.add_argument("--compute", choices=("f32", "bf16"), default="f32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stages", default=",".join(TRAIN_STAGES),
                   help="training stages to run (each needs the ones its "
                        "checkpoints come from)")
    p.add_argument("--evals", default=",".join(EVALS),
                   help="evaluation legs to run ('' for none)")
    p.add_argument("--root", default=os.path.join(REPO, "traj_run"),
                   help="working directory: corpus and both sides' runs")
    p.add_argument("--out", default=os.path.join(
        REPO, "TRAJECTORY_PARITY_TORCH.json"))
    p.add_argument("--rejudge", default=None, metavar="REPORT",
                   help="recompute the comparisons of a written report "
                        "(its curves and evaluation gaps) and write it to "
                        "--out, running nothing")
    args = p.parse_args(argv)
    if args.rejudge:
        report = judge(_read(args.rejudge))
    else:
        t0 = time.perf_counter()
        report = run(os.path.abspath(args.root), args.geometry,
                     args.epochs_scale, args.n_train, args.n_val,
                     args.compute, args.seed, args.encoder_dim_start,
                     args.zdim, evals=tuple(filter(None, args.evals.split(","))),
                     stages=tuple(args.stages.split(",")))
        report["wall_s"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"verdict": report["verdict"],
                      "first_failure": report["first_failure"],
                      "estoi": {k: v["estoi"].get("delta_diff")
                                for k, v in report["evals"].items()}},
                     indent=1))
    print(f"report: {args.out}")
    return report


if __name__ == "__main__":
    main()
