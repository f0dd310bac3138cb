"""Shared CLI plumbing: ini + flags -> configs, loaders and run dirs
(the training CLIs); checkpoint dirs and meta.json -> configs and
state_dicts, test-set pairing, SNR-bucket flags (the evaluation CLIs).

The port of `idccrn_vae_tpu/cli/common.py`, reading and writing the
port's checkpoint dirs (`train/checkpoint.py`: meta.json + best.pt /
state.pt). It keeps the reference's flag conventions: --skip_to_use as a
digit string ('012345', parsed char-wise like train.py:494-497),
--recon_loss_weight as a comma list ('1.0,1.0,0.0', train.py:498-503).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
from typing import Dict, Optional, Tuple

import torch

from idccrn_vae_torch.models.config import DccrnConfig, StftConfig
from idccrn_vae_torch.train.checkpoint import CheckpointManager
from idccrn_vae_torch.utils.config import IniConfig


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "without one the CLI exits unless given "
                        "--device cpu)")


def parse_skip_to_use(s: str) -> Tuple[int, ...]:
    return tuple(int(c) for c in s)


def parse_weights(s: str) -> Tuple[float, ...]:
    return tuple(float(w) for w in s.split(","))


def stft_from_ini(cfg: IniConfig) -> StftConfig:
    return StftConfig(
        n_fft=cfg.getint("STFT", "nfft"),
        hop=cfg.getint("STFT", "hopfrac"),
        win_length=cfg.getint("STFT", "winlen"),
        fs=cfg.getint("STFT", "fs"),
    )


def model_config(args, ini: IniConfig, latent_num: int = 1,
                 channel_mode: str = "normal",
                 skip_mode: Optional[str] = None) -> DccrnConfig:
    """DccrnConfig from reference-style flags (train.py:468-490)."""
    if skip_mode is None:
        if getattr(args, "skipc", False):
            skip_mode = "real"
        elif getattr(args, "skip_padding", False):
            skip_mode = "zero"  # "spadd"
        else:
            skip_mode = "none"
    d = getattr(args, "encoder_dim_start", 32)
    channels = (1, d, 2 * d, 4 * d, 4 * d, 8 * d, 8 * d)
    return DccrnConfig(
        stft=stft_from_ini(ini),
        encoder_channels=channels,
        causal=getattr(args, "causal", True),
        # the --zdim flag is the reference's source of truth
        # (train.py:474,518); [Network] z_dim is read only for callers
        # without the flag
        zdim=(args.zdim if hasattr(args, "zdim")
              else ini.getint("Network", "z_dim")),
        num_samples=getattr(args, "num_samples", 1),
        skip_to_use=parse_skip_to_use(getattr(args, "skip_to_use", "012345")),
        latent="fc" if getattr(args, "fclatent", False) else "sliced",
        latent_num=latent_num,
        channel_mode=channel_mode,
        skip_mode=skip_mode,
        recon_type=getattr(args, "recon_type", "real_imag"),
        resynthesis=getattr(args, "resynthesis", False),
        compute=getattr(args, "compute", "f32"),
    )


def datanorm_from_ini(ini: IniConfig, enabled: bool):
    if not enabled:
        return None
    from idccrn_vae_torch.data.stats import load_stats_txt

    return load_stats_txt(ini.get("User", "mean_file"),
                          ini.get("User", "std_file"))


def _index_cache_path(data_dir: str, name: str, split: str) -> str:
    """Where the segment-index cache lives: IDCCRN_CACHE_DIR if set,
    else next to the indexed corpus, not the working directory (a .txt
    file-list corpus caches beside the list file)."""
    root = os.environ.get("IDCCRN_CACHE_DIR")
    if not root:
        root = (data_dir if os.path.isdir(data_dir)
                else os.path.dirname(os.path.abspath(data_dir)))
    return os.path.join(root, f"{name}_{split}.json")


def loaders_from_ini(ini: IniConfig, mode: str, first_use: bool,
                     cache_dir: str = "."):
    """Train/val BatchLoaders for 'single'/'pair'/'triplet' corpora (the
    reference's three build_dataloader functions). Returns (train
    loader, val loader, train segments, val segments).

    `cache_dir` is a read-only fallback location of the index cache
    (older runs wrote it to the working directory); new caches are
    written to `_index_cache_path`."""
    from idccrn_vae_torch.data.loader import BatchLoader
    from idccrn_vae_torch.data.segments import (
        SegmentDataset,
        build_segment_index,
        find_wavs,
    )

    df = "DataFrame"
    seq_len = ini.getint(df, "sequence_len")
    batch_size = ini.getint(df, "batch_size")
    shuffle = ini.getboolean(df, "shuffle")
    workers = ini.getint(df, "num_workers")
    suffix = ini.get(df, "suffix")
    name = ini.get(df, "dataset_name")
    hop = ini.getint("STFT", "hopfrac")
    fs = ini.getint("STFT", "fs")
    trim = ini.getboolean("STFT", "trim")

    def build(split):
        if mode == "single":
            key = "train_data_dir" if split == "train" else "val_data_dir"
            data_dir = ini.get("User", key)
            clean_dir = noise_dir = None
        else:
            data_dir = ini.get("User", f"noisy_{split}_data_dir")
            clean_dir = ini.get("User", f"clean_{split}_data_dir")
            noise_dir = (ini.get("User", f"noise_{split}_data_dir")
                         if mode == "triplet" else None)
        files = find_wavs(data_dir, suffix)
        cache = _index_cache_path(data_dir, name, split)
        legacy = os.path.join(cache_dir, f"{name}_{split}.json")
        index = build_segment_index(
            files, seq_len, hop, fs, trim=trim, cache_path=cache,
            use_cache=not first_use, shuffle=shuffle,
            legacy_cache_paths=() if legacy == cache else (legacy,),
        )
        ds = SegmentDataset(index, mode, clean_dir, noise_dir)
        return BatchLoader(ds, batch_size, shuffle=shuffle,
                           num_threads=max(1, workers)), len(ds)

    train_loader, n_train = build("train")
    val_loader, n_val = build("val")
    return train_loader, val_loader, n_train, n_val


def make_save_dir(ini: IniConfig, model_name: str) -> str:
    root = ini.get("User", "saved_root")
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%Hh%M")
    path = os.path.join(root, f"{stamp}_{model_name}")
    os.makedirs(path, exist_ok=True)
    return path


def resolve_save_dir(args, ini: IniConfig, model_name: str) -> str:
    """Run directory of a train CLI. --reload requires --reload_savedir:
    a fresh timestamped dir would hold no checkpoint, and the run would
    restart from epoch 0 while the user believes it resumes."""
    if getattr(args, "reload", False):
        if not getattr(args, "reload_savedir", None):
            raise SystemExit(
                "--reload requires --reload_savedir (the existing run "
                "directory to resume)")
        return args.reload_savedir
    from idccrn_vae_torch.parallel import distributed

    # rank 0 makes the timestamped dir; the other ranks take its name
    return distributed.broadcast_object(
        make_save_dir(ini, model_name) if distributed.is_primary() else None)


def add_common_train_flags(p: argparse.ArgumentParser):
    p.add_argument("--cfg_file", type=str, required=True)
    p.add_argument("--first_use_dataset", action="store_true")
    p.add_argument("--causal", action="store_true")
    p.add_argument("--reload", action="store_true")
    p.add_argument("--reload_savedir", type=str, default=None)
    p.add_argument("--zdim", type=int, default=128)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--skip_to_use", type=str, default="012345")
    p.add_argument("--recon_type", type=str, default="real_imag")
    p.add_argument("--recon_loss_weight", type=str, default="1.0,1.0,0.0")
    p.add_argument("--resynthesis", action="store_true")
    p.add_argument("--compute", type=str, default="f32",
                   choices=["f32", "bf16"])
    p.add_argument("--encoder_dim_start", type=int, default=32,
                   help="first conv width; channels are (1, d, 2d, 4d, "
                        "4d, 8d, 8d) like net_config.py")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel world size: the largest count up "
                        "to this (default: every card) that divides the "
                        "batch, one rank per card (NCCL); with --device "
                        "cpu, this many Gloo processes")
    p.add_argument("--seed", type=int, default=123,
                   help="init/sampling seed (the reference pins 123)")
    p.add_argument("--donate", action="store_true",
                   help="accepted for command-line compatibility with the "
                        "JAX CLI, and has no effect: PyTorch updates the "
                        "weights and optimizer state in place")
    add_device_arg(p)
    return p


def data_parallel(main, argv, n_devices: Optional[int], batch_size: int,
                  device: torch.device, body):
    """Run a CLI's `body()` data-parallel, as the JAX CLIs run their step
    over `auto_mesh(batch_size, n_devices)`.

      * Inside a process group (a rank this function spawned, or a caller
        that made one), `body()` runs as this group's rank.
      * Under `torchrun` (RANK and WORLD_SIZE set) this process joins
        that group (NCCL on cards, Gloo on the CPU), runs `body()` and
        leaves it.
      * Otherwise the world size is `auto_world(batch_size, n_devices,
        device)`: at 1, `body()` runs in this process with no group; above
        1, that many ranks are spawned (one card each, or Gloo processes
        for --device cpu), each calling `main(argv)` again, and rank 0's
        return value is returned.

    A failed group start raises; nothing falls back to one process."""
    import sys

    from idccrn_vae_torch.parallel import distributed
    from idccrn_vae_torch.parallel.mesh import auto_world

    if distributed.active():
        distributed.local_batch_size(batch_size)
        return body()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        distributed.initialize(device=device)
        try:
            distributed.local_batch_size(batch_size)
            return body()
        finally:
            distributed.shutdown()
    world = auto_world(batch_size, n_devices, device)
    if world == 1:
        return body()
    argv = list(sys.argv[1:] if argv is None else argv)
    return distributed.spawn(main, world, args=(argv,), device=device)


def train_logger(save_dir: str):
    """The run's train.log on rank 0 of a data-parallel run (and in a
    single process); a silent logger on the other ranks."""
    import logging

    from idccrn_vae_torch.parallel import distributed
    from idccrn_vae_torch.utils.logger import get_logger

    if distributed.is_primary():
        return get_logger(f"{save_dir}/train.log", 1)
    logger = logging.getLogger("idccrn_vae_torch.rank")
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


def bucket_map_from_meta(meta_path: str, split: str = "val"):
    """(utterance name -> SNR bucket label, bucket order) from a
    data/synth.py corpus_meta.json — feeds the eval runners'
    per-SNR-bucket median report (the reference's published format)."""
    with open(meta_path) as f:
        meta = json.load(f)
    prefix = f"{split}/"
    bucket_of = {k[len(prefix):]: v["bucket"]
                 for k, v in meta.get("files", {}).items()
                 if k.startswith(prefix)}
    return bucket_of, meta.get("buckets", [])


def add_bucket_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--corpus_meta", type=str, default=None,
                   help="corpus_meta.json (data/synth.py) — adds a "
                        "per-SNR-bucket median report to the summary")
    p.add_argument("--corpus_split", type=str, default="val",
                   help="which split's bucket labels to use")


def bucket_kwargs(args) -> dict:
    if not getattr(args, "corpus_meta", None):
        return {}
    bucket_of, order = bucket_map_from_meta(args.corpus_meta,
                                            args.corpus_split)
    return {"bucket_of": bucket_of, "bucket_order": order}


def match_clean_paths(noisy_paths, clean_dir: str):
    """Clean companion per noisy file: same basename if present, else
    the DNS '*_fileid_<id>' convention (dataload_nsvae.py:177-192)."""
    from idccrn_vae_torch.data.segments import companion_paths

    out = []
    for p in noisy_paths:
        cand = os.path.join(clean_dir, os.path.basename(p))
        if not os.path.exists(cand):
            cand, _ = companion_paths(p, clean_dir, clean_dir)
        out.append(cand)
    return out


def _module_for(kind: str, cfg: DccrnConfig):
    """A CPU port module of `kind`, whose state_dict names the keys a
    reference checkpoint of that kind must provide."""
    from idccrn_vae_torch.models.dccrn import SupervisedDccrn
    from idccrn_vae_torch.models.nsvae import NsvaeEncoder
    from idccrn_vae_torch.models.vae import VaeDecoder, VaeEncoder

    modules = {"vae_encoder": VaeEncoder, "vae_decoder": VaeDecoder,
               "nsvae_encoder": NsvaeEncoder, "supervised": SupervisedDccrn}
    if kind not in modules:
        raise ValueError(f"unknown kind {kind}")
    return modules[kind](cfg, device="cpu")


def _load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference torch checkpoint (or bare state_dict) -> its
    state_dict, unwrapped from `model_state_dict` as
    `idccrn_vae_tpu/models/torch_import.py` `load_state_dict` does."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if not (isinstance(obj, dict)
            and all(isinstance(v, torch.Tensor) for v in obj.values())):
        raise ValueError(f"not a state_dict-like checkpoint: {path}")
    return obj


def load_pretrained_variables(path: str, kind: str, cfg: DccrnConfig,
                              which: str = "enc"):
    """Pretrained weights as a port state_dict, from either a port
    CheckpointManager directory (meta.json + best.pt; `which` picks the
    entry of a multi-model snapshot) or a reference torch .pt/.pth file.

    A reference file contributes exactly the keys the port module of
    `kind` ('vae_encoder', 'vae_decoder', 'nsvae_encoder',
    'supervised') holds — the keys `torch_import.import_*` reads; any
    other key (optimizer state, the supervised model's dead `linear`
    conv) is left out, and a missing one raises."""
    if path.endswith(".pt") or path.endswith(".pth"):
        sd = _load_reference_state_dict(path)
        wanted = _module_for(kind, cfg).state_dict()
        missing = sorted(set(wanted) - set(sd))
        if missing:
            raise KeyError(f"{path} lacks the {kind} keys {missing}")
        return {k: sd[k].to(torch.float32) for k in wanted}
    best = CheckpointManager(path).load_best()
    return best[which] if which in best else best


def config_from_meta(meta: dict, key: str = "config") -> DccrnConfig:
    d = dict(meta[key])
    d["stft"] = StftConfig(**d["stft"])
    for k in ("encoder_channels", "kernel", "stride", "skip_to_use"):
        if k in d:
            d[k] = tuple(d[k])
    return DccrnConfig(**d)


def load_enhancement_checkpoints(nsvae_dir: str,
                                 decoder_dir: Optional[str] = None,
                                 noise_decoder_dir: Optional[str] = None,
                                 phase: int = 1):
    """Shared model-loading for the enhancement-serving entry points
    (test_enhance / stream_enhance).

    phase 1: NSVAE checkpoint supplies the noisy encoder; the pretrained
    CVAE decoder comes from decoder_dir (+ optional NVAE decoder).
    phase 2: the phase-2 checkpoint holds encoder AND fine-tuned
    decoder(s). Returns (enc_cfg, dec_cfg, enc_state, dec_state,
    noise_dec_state, pad_mode)."""
    ckpt = CheckpointManager(nsvae_dir)
    meta = ckpt.load_meta()
    best = ckpt.load_best()
    if phase == 1:
        enc_cfg = config_from_meta(meta, "noisy_config")
        dec_cfg = config_from_meta(meta, "pre_config")
        enc_state = best["noisy_enc"]
        if not decoder_dir:
            raise SystemExit("phase 1 requires --decoder_dir "
                             "(pretrained CVAE decoder)")
        dec_state = CheckpointManager(decoder_dir).load_best()["dec"]
        noise_dec_state = None
        if noise_decoder_dir:
            noise_dec_state = CheckpointManager(
                noise_decoder_dir).load_best()["dec"]
        pad_mode = "sig" if dec_cfg.skip_mode == "real" else "zero"
    else:
        enc_cfg = config_from_meta(meta, "enc_config")
        dec_cfg = config_from_meta(meta, "dec_config")
        enc_state = best["encoder"]
        dec_state = best["decoder"]
        noise_dec_state = best.get("noise_decoder")
        pad_mode = "sig"
    return enc_cfg, dec_cfg, enc_state, dec_state, noise_dec_state, pad_mode
