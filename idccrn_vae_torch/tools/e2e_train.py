"""The whole I-DCCRN-VAE recipe at reference geometry on one card, end to
end, through the port's CLIs and checkpoint chain: corpus -> CVAE + NVAE
pretraining -> NSVAE posterior matching -> phase-2 decoder fine-tuning
(classical and adversarial) -> held-out enhancement evaluation of each
leg (and the latent_num 2 phase-1 program through its four out-types)
-> the supervised DCCRN baseline -> DNSMOS of the enhanced sets.

The counterpart of tools/e2e_train_tpu.py, with the same corpus (the
speech-like surrogate of data/synth.py: 96 training and 104 validation
utterances of 6.5 s, DNS3-style SNR buckets), the same ini text, the same
stages in the same order and the same CLI arguments, plus `--device`.
Geometry: zdim 128, encoder channels (1,32,64,128,128,256,256), 481-frame
(3 s) segments, nfft 512 / hop 100 / win 400, causal, bf16 compute.

Writes E2E_TRAIN_TORCH.json at the repo root (or --out): per stage its
wall time, loss curves, eval summary, deltas against the noisy input
and per-SNR-bucket medians, merged into an existing report; and a
`jax_reference` block that puts each leg's delta beside the JAX run's,
read from the committed E2E_TRAIN.json.

Usage:  python -m idccrn_vae_torch.tools.e2e_train [--root DIR]
        [--epochs-scale S] [--stages a,b,...] [--skip-corpus]
        [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

from idccrn_vae_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FS = 16000
UTT_SECONDS = 6.5  # 2 full 3 s training segments per utterance
N_TRAIN = 96
N_VAL = 104  # 26 per SNR bucket; 208 segments = 13 full val batches of 16

STAGES = ("cvae,nvae,nsvae,p2,p2adv,eval,evaladv,evalp1,sup,evalsup,"
          "dnsmos")
OUTTYPES = ("clean_direct", "real_imag_mask", "complex_mask", "phase_mask")
DNSMOS_SETS = ("enhanced_p2", "enhanced_p2adv", "enhanced_sup")


def make_corpus(root):
    from idccrn_vae_torch.data.synth import make_corpus as synth_corpus

    dirs, _ = synth_corpus(root, N_TRAIN, N_VAL, UTT_SECONDS, FS)
    return dirs


def load_bucket_map(root, split="val"):
    """fileid wav name -> SNR bucket label, from corpus_meta.json
    (missing file -> empty)."""
    from idccrn_vae_torch.cli.common import bucket_map_from_meta

    path = os.path.join(root, "corpus_meta.json")
    if not os.path.exists(path):
        return {}, []
    return bucket_map_from_meta(path, split)


def write_ini(root, dirs, name, model_name, batch_size, epochs, extra=""):
    path = os.path.join(root, f"{name}.ini")
    with open(path, "w") as f:
        f.write(f"""[User]
logger_type = 2
saved_root = {root}/models_{name}
train_data_dir = {dirs['clean_train'] if 'cvae' in name else dirs['noise_train']}
val_data_dir = {dirs['clean_val'] if 'cvae' in name else dirs['noise_val']}
noisy_train_data_dir = {dirs['noisy_train']}
clean_train_data_dir = {dirs['clean_train']}
noise_train_data_dir = {dirs['noise_train']}
noisy_val_data_dir = {dirs['noisy_val']}
clean_val_data_dir = {dirs['clean_val']}
noise_val_data_dir = {dirs['noise_val']}
model_name = {model_name}
{extra}[STFT]
winlen = 400
nfft = 512
hopfrac = 100
fs = 16000
trim = False
[Network]
z_dim = 128
clean_encoder = False
clean_decoder = False
noise_encoder = False
noise_decoder = False
[Training]
optimization = adam
lr = 1e-3
epochs = {epochs}
early_stop_patience = {epochs}
save_frequency = 5
[DataFrame]
dataset_name = e2e_{name}
suffix = wav
num_workers = 2
batch_size = {batch_size}
shuffle = True
sequence_len = 481
""")
    return path


def latest(root, name):
    d = os.path.join(root, f"models_{name}")
    return os.path.join(d, sorted(os.listdir(d))[-1])


def load_curves(model_dir):
    from idccrn_vae_torch.train.checkpoint import CheckpointManager

    out = {}
    try:
        meta = CheckpointManager(model_dir).load_meta()
        out.update(epoch=meta.get("epoch"), best_val=meta.get("best_val"))
    except Exception as e:  # pragma: no cover
        out["meta_error"] = str(e)
    curves_path = os.path.join(model_dir, "loss_curves.json")
    if os.path.exists(curves_path):
        with open(curves_path) as f:
            c = json.load(f)
        for split in ("train", "val"):
            series = c.get(split) or []
            out[f"{split}_total"] = [
                round(e["total"], 4) if "total" in e else None
                for e in series]
            if series:
                out[f"{split}_last"] = {k: round(v, 4)
                                        for k, v in series[-1].items()}
    return out


def jax_reference(report: dict, jax_report: dict, source: str) -> dict:
    """Each leg's delta against the noisy input: the JAX run's (from
    `jax_report`, the committed E2E_TRAIN.json), this run's, and this
    run's minus JAX's, per metric both reports hold."""
    ours, theirs = report.get("stages", {}), jax_report.get("stages", {})

    def deltas(stages, stage, *keys):
        entry = stages.get(stage) or {}
        for k in keys:
            entry = entry.get(k) or {}
        return entry

    legs = {}
    names = [(s, (s, "delta_vs_noisy"))
             for s in ("eval", "evaladv", "evalsup")]
    names += [(f"evalp1/{o}", ("evalp1", o, "delta_vs_noisy"))
              for o in OUTTYPES]
    names += [(f"dnsmos/{t}", ("dnsmos", f"delta_{t}")) for t in DNSMOS_SETS]
    for leg, path in names:
        port, ref = deltas(ours, *path), deltas(theirs, *path)
        common = [k for k in ref if k in port]
        if common:
            legs[leg] = {k: {"jax": ref[k], "port": port[k],
                             "diff": round(port[k] - ref[k], 4)}
                         for k in common}
    return {"source": source, "legs": legs}


def card_info(device) -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    import torch

    if device.type != "cuda":
        return {"device": str(device)}
    info = {"device": str(device),
            "name": torch.cuda.get_device_name(device)}
    try:
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = f"unavailable: {e}"
    return info


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=os.path.join(REPO, "e2e_run"),
                    help="working directory: corpus, runs, evaluations")
    ap.add_argument("--epochs-scale", type=float, default=1.0,
                    help="multiply every stage's epoch count")
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  "E2E_TRAIN_TORCH.json"))
    ap.add_argument("--jax-report", default=os.path.join(REPO,
                                                         "E2E_TRAIN.json"),
                    help="the JAX run's report, for jax_reference")
    ap.add_argument("--skip-corpus", action="store_true")
    ap.add_argument("--stages", default=STAGES,
                    help="comma list of stages to (re)run; 'figures' "
                         "(needs matplotlib) is not in the default")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; without "
                         "one it exits unless given --device cpu)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dev = ["--device", str(device)]
    root = os.path.abspath(args.root)
    report_path = os.path.abspath(args.out)
    os.makedirs(root, exist_ok=True)
    os.chdir(root)
    stages = set(args.stages.split(","))
    sc = args.epochs_scale
    geometry = {"zdim": 128, "encoder_dim_start": 32,
                "sequence_len": 481, "causal": True,
                "compute": "bf16", "fs": FS,
                "train_utts": N_TRAIN, "val_utts": N_VAL,
                "corpus": "data/synth.py speech-like surrogate, "
                          "DNS3-style SNR buckets"}
    report = {"geometry": geometry, "stages": {}}
    if os.path.exists(report_path):
        with open(report_path) as f:
            try:
                report = json.load(f)
            except Exception:
                pass
        report["geometry"] = geometry  # never keep a stale geometry
    report["epochs_scale"] = sc
    report["card"] = card_info(device)
    jax_report = {}
    if os.path.exists(args.jax_report):
        with open(args.jax_report) as f:
            jax_report = json.load(f)

    def record(stage, wall, model_dir=None, extra=None):
        entry = {"wall_s": round(wall, 1), "epochs_scale": sc}
        if model_dir:
            entry["model_dir"] = model_dir
            entry.update(load_curves(model_dir))
        if extra:
            entry.update(extra)
        report.setdefault("stages", {})[stage] = entry
        report["jax_reference"] = jax_reference(
            report, jax_report, os.path.basename(args.jax_report))
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1, default=float)

    dirs = ({k: os.path.join(root, k) for k in
             ("clean_train", "clean_val", "noise_train", "noise_val",
              "noisy_train", "noisy_val")}
            if args.skip_corpus else make_corpus(root))

    GEO = ["--causal", "--compute", "bf16", "--first_use_dataset"]

    if "cvae" in stages or "nvae" in stages:
        from idccrn_vae_torch.cli.train_vae import main as train_vae

        for name, model in (("cvae", "complex_CVAE"),
                            ("nvae", "complex_NVAE")):
            if name not in stages:
                continue
            print(f"== pretrain {model} ==", flush=True)
            t0 = time.time()
            train_vae(["--cfg_file",
                       write_ini(root, dirs, name, model, 16,
                                 max(2, int(30 * sc))),
                       *GEO, "--skip_padding", "--kl_ann_flag",
                       "--kl_warm_epochs", str(max(1, int(10 * sc))),
                       "--kl_weight", "0.01", *dev])
            record(name, time.time() - t0, latest(root, name))

    if "nsvae" in stages:
        from idccrn_vae_torch.cli.train_nsvae import main as train_nsvae

        print("== NSVAE posterior matching ==", flush=True)
        cvae, nvae = latest(root, "cvae"), latest(root, "nvae")
        t0 = time.time()
        train_nsvae(["--cfg_file", write_ini(
            root, dirs, "nsvae", "complex_NSVAE", 16, max(2, int(25 * sc)),
            extra=(f"pre_clean_encoder = {cvae}\n"
                   f"pre_noise_encoder = {nvae}\n")),
            *GEO, "--nsvae_model", "original", "--latent_num", "2",
            "--alpha", "1.0", "--w_kl", "1.0", "--w_dismiu", "0.1", *dev])
        record("nsvae", time.time() - t0, latest(root, "nsvae"))

    if "p2" in stages:
        from idccrn_vae_torch.cli.train_phase2 import main as train_phase2

        print("== phase-2 classical decoder fine-tune ==", flush=True)
        t0 = time.time()
        train_phase2(["--cfg_file",
                      write_ini(root, dirs, "p2", "phase2_classical", 14,
                                max(2, int(25 * sc))),
                      *GEO, "--first_phase_folder", latest(root, "nsvae"),
                      "--use_sc_phase2", "--recon_type", "mask",
                      "--latent_num", "1", *dev])
        record("p2", time.time() - t0, latest(root, "p2"))

    if "p2adv" in stages:
        from idccrn_vae_torch.cli.train_phase2 import main as train_phase2

        # B=15, the reference's adversarial batch, as one fused step: the
        # decoder and D update in one program (the JAX package's split
        # G/D programs are a TPU memory workaround the port does not need)
        print("== phase-2 adversarial decoder fine-tune ==", flush=True)
        t0 = time.time()
        train_phase2(["--cfg_file",
                      write_ini(root, dirs, "p2adv", "phase2_adversarial",
                                15, max(2, int(25 * sc))),
                      *GEO, "--first_phase_folder", latest(root, "nsvae"),
                      "--use_sc_phase2", "--recon_type", "mask",
                      "--latent_num", "1", "--adversarial",
                      "--dlr", "1e-4", "--d_step", "3", *dev])
        record("p2adv", time.time() - t0, latest(root, "p2adv"))

    def bucket_report(out_dir):
        """Per-SNR-bucket median table from the eval's per-utterance
        score files + corpus_meta.json."""
        from idccrn_vae_torch.eval.report import bucketed_median_report

        bucket_of, order = load_bucket_map(root)
        pu_path = os.path.join(out_dir, "per_utterance.json")
        npu_path = os.path.join(out_dir, "noisy_per_utterance.json")
        if not (bucket_of and os.path.exists(pu_path)
                and os.path.exists(npu_path)):
            return None
        with open(pu_path) as f:
            per_utt = json.load(f)
        with open(npu_path) as f:
            noisy_per_utt = json.load(f)
        return bucketed_median_report(per_utt, noisy_per_utt, bucket_of,
                                      order)

    def bucket_flags():
        meta_path = os.path.join(root, "corpus_meta.json")
        return (["--corpus_meta", meta_path]
                if os.path.exists(meta_path) else [])

    def run_eval(stage, model_name, out_name):
        from idccrn_vae_torch.cli.test_enhance import main as test_enhance
        from idccrn_vae_torch.eval.report import format_bucket_table

        print(f"== held-out enhancement eval ({model_name}) ==", flush=True)
        out_dir = os.path.join(root, out_name)
        t0 = time.time()
        test_enhance(["--nsvae_dir", latest(root, model_name), "--phase",
                      "2", "--noisy_dir", dirs["noisy_val"],
                      "--clean_dir", dirs["clean_val"],
                      "--out_dir", out_dir, "--num_samples", "10",
                      "--batch_size", "12", "--compute", "bf16",
                      "--write_wavs", *bucket_flags(), *dev])
        wall = time.time() - t0
        with open(os.path.join(out_dir, "summary.json")) as f:
            summary = json.load(f)
        deltas = {k: round(v["mean"], 4)
                  for k, v in summary.get("delta", {}).items()}
        buckets = summary.get("per_snr_bucket") or bucket_report(out_dir)
        if buckets:
            print(format_bucket_table(buckets), flush=True)
        record(stage, wall, extra={
            "summary": summary.get("summary"),
            "noisy_summary": summary.get("noisy_summary"),
            "delta_vs_noisy": deltas,
            "per_snr_bucket": buckets,
            "provenance": summary.get("provenance"),
        })
        ok = deltas.get("sisdr", -1) > 0
        print(f"deltas vs noisy: {deltas}  ->  "
              f"{'POSITIVE SI-SNR GAIN' if ok else 'NO GAIN YET'}")

    if "eval" in stages:
        run_eval("eval", "p2", "eval_p2")
    if "evaladv" in stages:
        run_eval("evaladv", "p2adv", "eval_p2adv")

    if "evalp1" in stages:
        # phase 1, latent_num 2, through all four out-types: the NSVAE's
        # noisy encoder with the pretrained CVAE speech decoder and NVAE
        # noise decoder (the mask out-types combine both decoded spectra
        # against the noisy STFT)
        from idccrn_vae_torch.cli.test_enhance import main as test_enhance

        cvae, nvae, nsvae = (latest(root, n)
                             for n in ("cvae", "nvae", "nsvae"))
        entry = {}
        t_all = time.time()
        for outtype in OUTTYPES:
            print(f"== phase-1 latent_num=2 eval ({outtype}) ==",
                  flush=True)
            out_dir = os.path.join(root, f"eval_p1_{outtype}")
            t0 = time.time()
            test_enhance(["--nsvae_dir", nsvae, "--phase", "1",
                          "--decoder_dir", cvae,
                          "--noise_decoder_dir", nvae,
                          "--latent_to_use", "2", "--outtype", outtype,
                          "--noisy_dir", dirs["noisy_val"],
                          "--clean_dir", dirs["clean_val"],
                          "--out_dir", out_dir, "--num_samples", "10",
                          "--batch_size", "12", "--compute", "bf16",
                          *bucket_flags(), *dev])
            with open(os.path.join(out_dir, "summary.json")) as f:
                summary = json.load(f)
            deltas = {k: round(v["mean"], 4)
                      for k, v in summary.get("delta", {}).items()}
            entry[outtype] = {
                "wall_s": round(time.time() - t0, 1),
                "summary": summary.get("summary"),
                "delta_vs_noisy": deltas,
            }
            entry.setdefault("noisy_summary",
                             summary.get("noisy_summary"))
            print(f"  {outtype} deltas vs noisy: {deltas}", flush=True)
        record("evalp1", time.time() - t_all, extra=entry)

    if "sup" in stages:
        # the supervised DCCRN baseline on the same corpus
        from idccrn_vae_torch.cli.train_supervised import main as train_sup

        print("== supervised DCCRN baseline ==", flush=True)
        t0 = time.time()
        train_sup(["--cfg_file",
                   write_ini(root, dirs, "sup", "supervised_DCCRN", 16,
                             max(2, int(25 * sc))),
                   *GEO, "--recon_type", "mask", *dev])
        record("sup", time.time() - t0, latest(root, "sup"))

    if "evalsup" in stages:
        from idccrn_vae_torch.cli.test_supervised import main as test_sup

        print("== held-out enhancement eval (supervised) ==", flush=True)
        out_dir = os.path.join(root, "eval_sup")
        t0 = time.time()
        test_sup(["--model_dir", latest(root, "sup"),
                  "--noisy_dir", dirs["noisy_val"],
                  "--clean_dir", dirs["clean_val"],
                  "--out_dir", out_dir, "--batch_size", "12",
                  "--write_wavs", *dev])
        wall = time.time() - t0
        with open(os.path.join(out_dir, "summary.json")) as f:
            summary = json.load(f)
        # no noisy baseline of its own: pair it with the noisy_summary of
        # the phase-2 eval stage (the same val split and scorer)
        noisy = report["stages"].get("eval", {}).get("noisy_summary", {})
        if not noisy:
            raise SystemExit(
                "evalsup needs the 'eval' stage's noisy_summary in the "
                "report for the paired delta — run the eval stage first")
        deltas = {k: round(summary["summary"][k]["mean"]
                           - noisy[k]["mean"], 4)
                  for k in summary.get("summary", {}) if k in noisy}
        sup_bucket = None
        npu_path = os.path.join(root, "eval_p2",
                                "noisy_per_utterance.json")
        pu_path = os.path.join(out_dir, "per_utterance.json")
        if os.path.exists(npu_path) and os.path.exists(pu_path):
            from idccrn_vae_torch.eval.report import (
                bucketed_median_report,
                format_bucket_table,
            )

            bucket_of, order = load_bucket_map(root)
            if bucket_of:
                with open(pu_path) as f:
                    per_utt = json.load(f)
                with open(npu_path) as f:
                    noisy_per_utt = json.load(f)
                sup_bucket = bucketed_median_report(
                    per_utt, noisy_per_utt, bucket_of, order)
                print(format_bucket_table(sup_bucket), flush=True)
        record("evalsup", wall, extra={
            "summary": summary.get("summary"),
            "delta_vs_noisy": deltas,
            "per_snr_bucket": sup_bucket,
            "provenance": summary.get("provenance"),
        })
        print(f"supervised deltas vs noisy: {deltas}")

    if "dnsmos" in stages:
        # reference-free MOS of the trained enhancers against their noisy
        # input, over the whole val set per condition (the same fileids
        # in every dir, so the deltas stay paired)
        from idccrn_vae_torch.eval.dnsmos import (
            ComputeScore,
            default_model_paths,
        )

        scorer = ComputeScore(*default_model_paths(False), device=device)
        print("== DNSMOS scoring ==", flush=True)
        t0 = time.time()
        entry = {}
        for tag, d in (("noisy", dirs["noisy_val"]),
                       ("enhanced_p2", os.path.join(root, "eval_p2",
                                                    "enhanced")),
                       ("enhanced_p2adv", os.path.join(root, "eval_p2adv",
                                                       "enhanced")),
                       ("enhanced_sup", os.path.join(root, "eval_sup",
                                                     "enhanced"))):
            if not os.path.isdir(d):
                continue
            wavs = sorted(f for f in os.listdir(d) if f.endswith(".wav"))
            rows = [scorer(os.path.join(d, f)) for f in wavs]
            entry.setdefault("files_per_dir", len(rows))
            entry[tag] = {k: round(float(np.mean([r[k] for r in rows])), 4)
                          for k in ("OVRL", "SIG", "BAK", "P808_MOS")}
            print(f"  {tag}: {entry[tag]}", flush=True)
        for tag in DNSMOS_SETS:
            if tag in entry and "noisy" in entry:
                entry[f"delta_{tag}"] = {
                    k: round(entry[tag][k] - entry["noisy"][k], 4)
                    for k in entry[tag]}
        record("dnsmos", time.time() - t0, extra=entry)

    if "figures" in stages:
        # grouped per-SNR-bucket box plots of all systems (needs
        # matplotlib)
        from idccrn_vae_torch.eval.report import plot_bucket_boxes

        bucket_of, order = load_bucket_map(root)
        systems = {}
        npu = os.path.join(root, "eval_p2", "noisy_per_utterance.json")
        if os.path.exists(npu):
            with open(npu) as f:
                systems["Noisy"] = json.load(f)
        for tag, name in (("eval_p2", "I-DCCRN-VAE (CF)"),
                          ("eval_p2adv", "I-DCCRN-VAE (ADV)"),
                          ("eval_sup", "DCCRN (supervised)")):
            p = os.path.join(root, tag, "per_utterance.json")
            if os.path.exists(p):
                with open(p) as f:
                    systems[name] = json.load(f)
        if bucket_of and systems:
            print("== results figure ==", flush=True)
            png = os.path.join(root, "results_combined_metrics.png")
            t0 = time.time()
            plot_bucket_boxes(
                systems, bucket_of, png, bucket_order=order,
                title="Held-out enhancement by input SNR "
                      "(synthetic speech-like corpus)",
                baseline="Noisy")
            record("figures", time.time() - t0,
                   extra={"figure": png, "systems": list(systems)})
            print(f"figure: {png}")
    print(f"report: {report_path}")


if __name__ == "__main__":
    main()
