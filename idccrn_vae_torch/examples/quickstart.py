"""Quickstart: the whole I-DCCRN-VAE pipeline of the port on a synthetic
mini-corpus.

The counterpart of the repo's `examples/quickstart.py`: the same corpus
(4 utterances of 0.5 s per split, tone plus noise), the same ini text
and tiny flags, and the same five stages, each through the port's own
CLIs and checkpoint dirs:

  1. CVAE + NVAE pretraining        (cli.train_vae)
  2. NSVAE posterior matching       (cli.train_nsvae)
  3. phase-2 adversarial fine-tune  (cli.train_phase2 --adversarial)
  4. enhancement eval + metrics     (cli.test_enhance)
  5. streaming inference demo       (eval.streaming), its output written
     to <workdir>/stream/streamed.wav

Swap the synthetic corpus for DNS/VB-DMD/WSJ0-QUT directories and drop
the tiny flags (--encoder_dim_start 2 --zdim 4) for real runs.

Usage:  python -m idccrn_vae_torch.examples.quickstart [workdir]
            [--device cpu]

It runs on the CUDA card unless given --device cpu; without a card and
without that flag it exits with an error before writing anything.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from idccrn_vae_torch.data.audio_io import write_wav
from idccrn_vae_torch.device import resolve_device

FS = 16000
TINY = ["--zdim", "4", "--encoder_dim_start", "2", "--num_samples", "1",
        "--causal", "--first_use_dataset"]
STAGES = ("pretrain", "nsvae", "phase2", "eval", "stream")


def make_corpus(root):
    rng = np.random.default_rng(0)
    dirs = {}
    for name in ("clean_train", "clean_val", "noise_train", "noise_val",
                 "noisy_train", "noisy_val"):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        dirs[name] = d
    for i in range(4):
        t = np.arange(8000) / FS
        clean = 0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t) * (
            1 + 0.5 * np.sin(2 * np.pi * 3 * t))
        noise = 0.12 * rng.standard_normal(len(t))
        for split in ("train", "val"):
            write_wav(f"{dirs[f'clean_{split}']}/clean_fileid_{i}.wav",
                      clean.astype(np.float32), FS)
            write_wav(f"{dirs[f'noise_{split}']}/noise_fileid_{i}.wav",
                      noise.astype(np.float32), FS)
            write_wav(f"{dirs[f'noisy_{split}']}/noisy_fileid_{i}.wav",
                      (clean + noise).astype(np.float32), FS)
    return dirs


def write_ini(root, dirs, name, model_name, extra=""):
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
{extra}
[STFT]
winlen = 400
nfft = 512
hopfrac = 100
fs = 16000
trim = False
[Network]
z_dim = 4
clean_encoder = False
clean_decoder = False
noise_encoder = False
noise_decoder = False
[Training]
optimization = adam
lr = 1e-3
epochs = 2
early_stop_patience = 5
save_frequency = 1
[DataFrame]
dataset_name = quickstart_{name}
suffix = wav
num_workers = 1
batch_size = 2
shuffle = True
sequence_len = 17
""")
    return path


def latest(root, name):
    d = os.path.join(root, f"models_{name}")
    return os.path.join(d, sorted(os.listdir(d))[-1])


def main(argv=None) -> dict:
    """Runs the five stages; returns each stage's wall seconds."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("workdir", nargs="?", default="quickstart_out")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = str(resolve_device(args.device))
    dev = ["--device", device]
    root = os.path.abspath(args.workdir)
    os.makedirs(root, exist_ok=True)
    dirs = make_corpus(root)
    seconds = {}
    t0 = time.perf_counter()

    def done(stage):
        nonlocal t0
        seconds[stage] = time.perf_counter() - t0
        t0 = time.perf_counter()

    print("== 1/5 pretraining CVAE + NVAE ==")
    from idccrn_vae_torch.cli.train_vae import main as train_vae

    train_vae(["--cfg_file", write_ini(root, dirs, "cvae", "complex_CVAE"),
               *TINY, "--skip_padding", "--kl_weight", "0.01", *dev])
    train_vae(["--cfg_file", write_ini(root, dirs, "nvae", "complex_NVAE"),
               *TINY, "--skip_padding", "--kl_weight", "0.01", *dev])
    cvae, nvae = latest(root, "cvae"), latest(root, "nvae")
    done("pretrain")

    print("== 2/5 NSVAE posterior matching ==")
    from idccrn_vae_torch.cli.train_nsvae import main as train_nsvae

    train_nsvae(["--cfg_file", write_ini(
        root, dirs, "nsvae", "complex_NSVAE",
        extra=f"pre_clean_encoder = {cvae}\npre_noise_encoder = {nvae}\n"),
        *TINY, "--nsvae_model", "original", "--latent_num", "2",
        "--alpha", "1.0", "--w_kl", "1.0", "--w_dismiu", "0.1", *dev])
    nsvae = latest(root, "nsvae")
    done("nsvae")

    print("== 3/5 phase-2 adversarial decoder fine-tune ==")
    from idccrn_vae_torch.cli.train_phase2 import main as train_phase2

    train_phase2(["--cfg_file", write_ini(root, dirs, "p2", "phase2_adv"),
                  *TINY, "--first_phase_folder", nsvae, "--use_sc_phase2",
                  "--recon_type", "mask", "--latent_num", "1",
                  "--adversarial", "--dlr", "1e-4", "--d_step", "2", *dev])
    p2 = latest(root, "p2")
    done("phase2")

    print("== 4/5 enhancement evaluation ==")
    from idccrn_vae_torch.cli.test_enhance import main as test_enhance

    out_dir = os.path.join(root, "eval")
    test_enhance(["--nsvae_dir", p2, "--phase", "2",
                  "--noisy_dir", dirs["noisy_val"],
                  "--clean_dir", dirs["clean_val"], "--out_dir", out_dir,
                  "--num_samples", "2", "--batch_size", "2",
                  "--compute", "f32", "--write_wavs", *dev])
    with open(os.path.join(out_dir, "per_utterance.json")) as f:
        print(json.dumps(json.load(f), indent=1)[:400], "…")
    done("eval")

    print("== 5/5 streaming demo ==")
    from idccrn_vae_torch.cli.common import config_from_meta
    from idccrn_vae_torch.eval.streaming import StreamingEnhancer
    from idccrn_vae_torch.train.checkpoint import CheckpointManager

    ck = CheckpointManager(p2)
    meta, best = ck.load_meta(), ck.load_best()
    streamer = StreamingEnhancer(
        config_from_meta(meta, "enc_config"),
        config_from_meta(meta, "dec_config"),
        best["encoder"], best["decoder"], chunk_frames=10, device=device)
    wav = np.random.default_rng(1).standard_normal((1, 3000)).astype(
        np.float32) * 0.1
    out = streamer.stream(wav).cpu().numpy()
    os.makedirs(os.path.join(root, "stream"), exist_ok=True)
    write_wav(os.path.join(root, "stream", "streamed.wav"), out[0], FS)
    print(f"streamed {wav.shape[1]/FS:.2f}s in "
          f"{-(-wav.shape[1] // streamer.chunk_samples)} chunks -> "
          f"{out.shape}")
    done("stream")
    print(f"done on {device} — artifacts in {root}; stage seconds: "
          + json.dumps({k: round(v, 2) for k, v in seconds.items()}))
    return seconds


if __name__ == "__main__":
    main()
