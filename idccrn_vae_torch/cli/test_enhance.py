"""Speech-enhancement evaluation — test_nsvae_se.py / test_se_cvaefinetune.py.

--phase 1: pretrained CVAE decoder + NSVAE noisy encoder.
--phase 2: phase-2 fine-tuned decoder (classical or adversarial dir).

The port of `idccrn_vae_tpu.cli.test_enhance`, with the same flags plus
--device (default: the CUDA card). It reads the port's checkpoint dirs
(meta.json + best.pt). --compute int8 serves with int8 convolutions
(`ops/conv.quantized_conv`). --n_devices n evaluates data-parallel, as
the JAX CLI's mesh does (`cli/common.data_parallel`; default one
process): each padded batch is split over the ranks, and rank 0 gathers
the outputs, scores and writes (`Enhancer.enhance_batch`).
"""

from __future__ import annotations

import argparse
import dataclasses

from idccrn_vae_torch.cli.common import (
    add_bucket_args,
    add_device_arg,
    bucket_kwargs,
    data_parallel,
    load_enhancement_checkpoints,
    match_clean_paths,
)
from idccrn_vae_torch.data.segments import find_wavs
from idccrn_vae_torch.device import resolve_device
from idccrn_vae_torch.eval.enhance import Enhancer
from idccrn_vae_torch.eval.runners import run_enhancement_eval


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nsvae_dir", type=str, required=True,
                   help="NSVAE checkpoint dir (phase 1) or phase-2 dir")
    p.add_argument("--decoder_dir", type=str, default=None,
                   help="pretrained CVAE dir (phase 1) — defaults to the "
                        "decoder stored in nsvae_dir for phase 2")
    p.add_argument("--noise_decoder_dir", type=str, default=None,
                   help="pretrained NVAE decoder dir — enables the "
                        "latent_num=2 out-types in phase 1 "
                        "(test_nsvae_se.py --latent_to_use 2)")
    p.add_argument("--phase", type=int, default=1, choices=[1, 2])
    p.add_argument("--noisy_dir", type=str, required=True)
    p.add_argument("--clean_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--latent_to_use", type=int, default=1)
    p.add_argument("--outtype", type=str, default="clean_direct",
                   choices=["clean_direct", "real_imag_mask", "complex_mask",
                            "phase_mask"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--write_wavs", action="store_true")
    p.add_argument("--latent_diag", action="store_true",
                   help="collect mu covariance + speech/noise silhouette "
                        "diagnostics (test_nsvae_se.py latent analysis)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="shard eval batches over this many ranks (the "
                        "largest count up to it that divides "
                        "--batch_size): one per card, or Gloo processes "
                        "with --device cpu")
    p.add_argument("--compute", type=str, default="bf16",
                   choices=["f32", "bf16", "int8"],
                   help="operand dtype of the convs, LSTM and dense "
                        "layers; int8 = serving-only quantized convs "
                        "(per-sample activation and per-output-channel "
                        "weight scales, int32 accumulation), bf16 "
                        "elsewhere")
    p.add_argument("--sample_chunks", type=int, default=1,
                   help="decode num_samples in this many sequential "
                        "chunks — same outputs, peak decoder memory "
                        "divided by the chunk count")
    add_bucket_args(p)
    add_device_arg(p)
    return p


def main(argv=None):
    """Returns the evaluation result (`run_enhancement_eval`): in a
    data-parallel run, rank 0's."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    return data_parallel(main, argv, args.n_devices or 1, args.batch_size,
                         device, lambda: _evaluate(args, device))


def _evaluate(args, device):
    enc_cfg, dec_cfg, enc_state, dec_state, noise_dec_state, pad_mode = \
        load_enhancement_checkpoints(args.nsvae_dir, args.decoder_dir,
                                     args.noise_decoder_dir, args.phase)

    enc_cfg = dataclasses.replace(enc_cfg, compute=args.compute)
    dec_cfg = dataclasses.replace(dec_cfg, compute=args.compute)
    enhancer = Enhancer(
        enc_cfg, dec_cfg, enc_state, dec_state, noise_dec_state,
        num_samples=args.num_samples, outtype=args.outtype,
        latent_to_use=args.latent_to_use, pad_mode=pad_mode,
        sample_chunks=args.sample_chunks, device=device,
    )
    noisy_paths = find_wavs(args.noisy_dir)
    clean_paths = match_clean_paths(noisy_paths, args.clean_dir)
    return run_enhancement_eval(
        enhancer, noisy_paths, clean_paths, args.out_dir,
        batch_size=args.batch_size, write_wavs=args.write_wavs,
        latent_diagnostics=args.latent_diag, **bucket_kwargs(args),
    )


if __name__ == "__main__":
    main()
