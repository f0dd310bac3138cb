"""The port's end-to-end tool (idccrn_vae_torch/tools/e2e_train.py)
against tools/e2e_train_tpu.py, with every CLI `main` stubbed on both
sides: the same argv per stage (the JAX tool's, plus --device), the same
ini text, and the same report built from fabricated run dirs,
summary.json and per-utterance score files; the `jax_reference` block
read from the committed E2E_TRAIN.json; the default report path; and the
refusal to start without a card."""

import importlib.util
import json
import os
import sys

import pytest
import torch

from idccrn_vae_torch.tools import e2e_train as port_e2e

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_STAGES = port_e2e.STAGES
WAVS = [f"noisy_fileid_{i}.wav" for i in range(4)]
BUCKETS = ["[0, 5)", "[5, 10)"]


@pytest.fixture(scope="module")
def jax_e2e():
    spec = importlib.util.spec_from_file_location(
        "e2e_train_tpu", os.path.join(REPO, "tools", "e2e_train_tpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flag(argv, name):
    return argv[argv.index(name) + 1]


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _summary(seed):
    """summary.json of an eval runner: mean/median stats per metric and
    their deltas, made from `seed`."""
    metrics = ("rmse", "sisdr", "pesq", "estoi")
    stat = lambda v: {"mean": v, "mean_ci": 0.1, "median": v,
                      "median_ci": 0.1}
    return {"summary": {m: stat(seed + i) for i, m in enumerate(metrics)},
            "noisy_summary": {m: stat(i * 0.5) for i, m in
                              enumerate(metrics)},
            "delta": {m: stat(seed + i * 0.5) for i, m in
                      enumerate(metrics)},
            "provenance": {"n": len(WAVS)}}


def _per_utt(seed):
    return {w: {"sisdr": seed + i, "estoi": 0.1 * i}
            for i, w in enumerate(WAVS)}


class Stubs:
    """Records each CLI call's argv and writes what the tool reads next:
    a run dir with meta.json and loss_curves.json for a training CLI;
    summary.json, the per-utterance scores and enhanced wavs for an
    eval CLI."""

    def __init__(self):
        self.calls = []

    def make(self, name):
        def main(argv):
            self.calls.append((name, list(argv)))
            if name.startswith("train_"):
                ini = open(_flag(argv, "--cfg_file")).read()
                saved = ini.split("saved_root = ")[1].split("\n")[0]
                run = os.path.join(saved, "2026-01-01-00h00_run")
                _write(os.path.join(run, "meta.json"),
                       {"epoch": 3, "best_val": 1.25})
                _write(os.path.join(run, "loss_curves.json"),
                       {"train": [{"total": 2.0, "kl": 0.5}],
                        "val": [{"total": 1.5}]})
                return
            out = _flag(argv, "--out_dir")
            seed = 1.0 + len(self.calls)
            _write(os.path.join(out, "summary.json"), _summary(seed))
            _write(os.path.join(out, "per_utterance.json"), _per_utt(seed))
            _write(os.path.join(out, "noisy_per_utterance.json"),
                   _per_utt(0.0))
            if "--write_wavs" in argv:
                os.makedirs(os.path.join(out, "enhanced"), exist_ok=True)
                for w in WAVS:
                    open(os.path.join(out, "enhanced", w), "w").close()
        return main


class FakeScore:
    """DNSMOS scorer stand-in: scores from the file's directory and
    name."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, path):
        base = 1.0 + 0.25 * WAVS.index(os.path.basename(path))
        base += 0.5 * ("enhanced" in path) + 0.1 * ("eval_sup" in path)
        return {"OVRL": base, "SIG": base + 0.1, "BAK": base + 0.2,
                "P808_MOS": base + 0.3}


def _corpus(root):
    """The dirs --skip-corpus expects, four val wavs (file stubs) and a
    corpus_meta.json giving them two SNR buckets."""
    for d in ("clean_train", "clean_val", "noise_train", "noise_val",
              "noisy_train", "noisy_val"):
        os.makedirs(os.path.join(root, d))
    for w in WAVS:
        open(os.path.join(root, "noisy_val", w), "w").close()
    _write(os.path.join(root, "corpus_meta.json"),
           {"buckets": BUCKETS,
            "files": {f"val/{w}": {"bucket": BUCKETS[i % 2]}
                      for i, w in enumerate(WAVS)}})


CLIS = ("train_vae", "train_nsvae", "train_phase2", "train_supervised",
        "test_enhance", "test_supervised")


def _run_both(tmp_path, monkeypatch, jax_e2e):
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    _corpus(jroot)
    _corpus(troot)
    stubs = {"jax": Stubs(), "port": Stubs()}
    for name in CLIS:
        monkeypatch.setattr(f"idccrn_vae_tpu.cli.{name}.main",
                            stubs["jax"].make(name))
        monkeypatch.setattr(f"idccrn_vae_torch.cli.{name}.main",
                            stubs["port"].make(name))
    monkeypatch.setattr("idccrn_vae_tpu.eval.dnsmos.ComputeScore", FakeScore)
    monkeypatch.setattr("idccrn_vae_torch.eval.dnsmos.ComputeScore",
                        FakeScore)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.chdir(tmp_path)
    jout, tout = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    monkeypatch.setattr(sys, "argv", [
        "e2e_train_tpu.py", "--root", jroot, "--out", jout, "--skip-corpus",
        "--stages", ALL_STAGES])
    jax_e2e.main()
    port_e2e.main(["--root", troot, "--out", tout, "--skip-corpus",
                   "--device", "cpu"])
    with open(jout) as f, open(tout) as g:
        return (jroot, troot), stubs, json.load(f), json.load(g)


def _norm(value, root):
    if isinstance(value, str):
        return value.replace(root, "<root>")
    if isinstance(value, (list, tuple)):
        return [_norm(v, root) for v in value]
    if isinstance(value, dict):
        return {k: _norm(v, root) for k, v in value.items()}
    return value


def test_e2e_matches_the_jax_tool(tmp_path, monkeypatch, jax_e2e):
    """Every stage, --skip-corpus, the default stage list: the port's CLIs
    get the JAX tool's argv with `--device cpu` added, the ini files are
    the same text, and the report's stages hold the same entries (the wall
    times aside, and the scale, which only the port records)."""
    (jroot, troot), stubs, jrep, trep = _run_both(tmp_path, monkeypatch,
                                                  jax_e2e)
    jcalls = _norm(stubs["jax"].calls, jroot)
    tcalls = _norm(stubs["port"].calls, troot)
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    assert len(tcalls) == 13  # 6 trainings, 2 + 4 + 1 evaluations
    for (name, targv), (_, jargv) in zip(tcalls, jcalls):
        assert targv == jargv + ["--device", "cpu"], name
    inis = sorted(f for f in os.listdir(jroot) if f.endswith(".ini"))
    assert inis == sorted(f for f in os.listdir(troot) if f.endswith(".ini"))
    assert len(inis) == 6
    for ini in inis:
        with open(os.path.join(jroot, ini)) as f, \
                open(os.path.join(troot, ini)) as g:
            assert _norm(g.read(), troot) == _norm(f.read(), jroot), ini
    dirs = {k: os.path.join(troot, k) for k in
            ("clean_train", "clean_val", "noise_train", "noise_val",
             "noisy_train", "noisy_val")}
    for args in (("cvae", "complex_CVAE", 16, 30),
                 ("p2adv", "phase2_adversarial", 15, 25, "x = 1\n")):
        texts = []
        for mod, sub in ((port_e2e, "a"), (jax_e2e, "b")):
            d = tmp_path / sub
            d.mkdir(exist_ok=True)
            with open(mod.write_ini(str(d), dirs, *args)) as f:
                texts.append(f.read().replace(str(d), "<root>"))
        assert texts[0] == texts[1]

    assert trep["geometry"] == jrep["geometry"]
    assert trep["epochs_scale"] == 1.0 and trep["card"]["device"] == "cpu"
    assert list(trep["stages"]) == list(jrep["stages"])
    for stage, jentry in jrep["stages"].items():
        tentry = dict(trep["stages"][stage])
        assert tentry.pop("epochs_scale") == 1.0
        strip = lambda e: {k: v for k, v in e.items() if k != "wall_s"}
        if stage == "evalp1":
            for k in port_e2e.OUTTYPES:
                tentry[k], jentry[k] = strip(tentry[k]), strip(jentry[k])
        assert _norm(strip(tentry), troot) == _norm(strip(jentry), jroot), \
            stage
    assert trep["stages"]["eval"]["per_snr_bucket"] is not None
    assert trep["stages"]["dnsmos"]["files_per_dir"] == len(WAVS)


def test_report_sets_each_leg_beside_the_jax_run(tmp_path, monkeypatch,
                                                  jax_e2e):
    """jax_reference: per leg and metric the committed E2E_TRAIN.json's
    delta, this run's and their difference."""
    _, _, _, trep = _run_both(tmp_path, monkeypatch, jax_e2e)
    with open(os.path.join(REPO, "E2E_TRAIN.json")) as f:
        committed = json.load(f)["stages"]
    ref = trep["jax_reference"]
    assert ref["source"] == "E2E_TRAIN.json"
    want_legs = (["eval", "evaladv", "evalsup"]
                 + [f"evalp1/{o}" for o in port_e2e.OUTTYPES]
                 + [f"dnsmos/{t}" for t in port_e2e.DNSMOS_SETS])
    assert sorted(ref["legs"]) == sorted(want_legs)
    for leg, metrics in ref["legs"].items():
        stage, *sub = leg.split("/")
        if stage == "dnsmos":
            key = ("delta_" + sub[0],)
        else:
            key = (*sub, "delta_vs_noisy")
        jax_d, port_d = committed[stage], trep["stages"][stage]
        for k in key:
            jax_d, port_d = jax_d[k], port_d[k]
        assert sorted(metrics) == sorted(jax_d), leg
        for m, row in metrics.items():
            assert row["jax"] == jax_d[m] and row["port"] == port_d[m]
            assert row["diff"] == pytest.approx(port_d[m] - jax_d[m],
                                                abs=1e-4)
    assert ref["legs"]["eval"]["sisdr"]["jax"] == pytest.approx(3.9176)
    assert ref["legs"]["dnsmos/enhanced_p2"]["BAK"]["jax"] == \
        pytest.approx(1.6163)


def test_default_report_path_and_stages():
    args = port_e2e.build_parser().parse_args([])
    assert args.out == os.path.join(REPO, "E2E_TRAIN_TORCH.json")
    assert args.jax_report == os.path.join(REPO, "E2E_TRAIN.json")
    assert args.stages.split(",") == [
        "cvae", "nvae", "nsvae", "p2", "p2adv", "eval", "evaladv",
        "evalp1", "sup", "evalsup", "dnsmos"]
    assert args.device is None and args.epochs_scale == 1.0


def test_e2e_refuses_to_start_without_a_card(tmp_path, monkeypatch):
    """No card and no --device cpu: the tool raises before it makes its
    root, the corpus or the report."""
    assert not torch.cuda.is_available()
    called = []
    monkeypatch.setattr(port_e2e, "make_corpus", called.append)
    root = tmp_path / "run"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_e2e.main(["--root", str(root), "--out",
                       str(tmp_path / "r.json")])
    assert not root.exists() and not called
    assert os.listdir(tmp_path) == []
