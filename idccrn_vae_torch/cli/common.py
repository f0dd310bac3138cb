"""Shared CLI plumbing of the evaluation entry points: checkpoint dirs
and meta.json -> configs and state_dicts, test-set pairing, SNR-bucket
flags.

The evaluation part of `idccrn_vae_tpu/cli/common.py`, reading the
port's checkpoint dirs (`train/checkpoint.py`: meta.json + best.pt /
state.pt). The training helpers (ini loaders, model_config, save dirs)
belong to the trainers, which are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import torch

from idccrn_vae_torch.models.config import DccrnConfig, StftConfig
from idccrn_vae_torch.train.checkpoint import CheckpointManager


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "without one the CLI exits unless given "
                        "--device cpu)")


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
