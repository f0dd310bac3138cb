"""Export a trained enhancement model to a standalone serving artifact.

The port of `idccrn_vae_tpu.cli.export_model`, with the same flags plus
--device (default: the CUDA card). It reads the port's checkpoint dirs
and writes the whole serving program (STFT -> encoder -> latent ->
decoder -> ISTFT, weights as constants) as torch.export `.pt2` files
with a meta.json (`eval/export.py`); the artifact runs with torch alone,
on the device it was exported on (`load_artifact`), no checkpoint,
config or model code needed.

Examples:
  python -m idccrn_vae_torch.cli.export_model \
      --nsvae_dir ckpt/nsvae --decoder_dir ckpt/cvae --out_dir artifact/
  python -m idccrn_vae_torch.cli.export_model --model supervised \
      --model_dir ckpt/dccrn --out_dir artifact/ --seconds 1,3
  python -m idccrn_vae_torch.cli.export_model --streaming \
      --nsvae_dir ckpt/nsvae --decoder_dir ckpt/cvae --out_dir artifact/
"""

from __future__ import annotations

import argparse
import json
import time

from idccrn_vae_torch.cli.common import add_device_arg


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", type=str, default="nsvae",
                   choices=["nsvae", "supervised"])
    p.add_argument("--nsvae_dir", type=str, default=None)
    p.add_argument("--decoder_dir", type=str, default=None)
    p.add_argument("--noise_decoder_dir", type=str, default=None)
    p.add_argument("--phase", type=int, default=1, choices=[1, 2])
    p.add_argument("--model_dir", type=str, default=None,
                   help="supervised DCCRN checkpoint dir")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--seconds", type=str, default="3.0",
                   help="utterance length(s) the artifact is specialized "
                        "to; a comma list ('1,3,10') exports one bucket "
                        "per length and serving picks the smallest "
                        "covering bucket (batch stays symbolic)")
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--latent_to_use", type=int, default=1)
    p.add_argument("--outtype", type=str, default="clean_direct",
                   choices=["clean_direct", "real_imag_mask", "complex_mask",
                            "phase_mask"])
    p.add_argument("--streaming", action="store_true",
                   help="export the real-time chunked step (carried "
                        "state, causal checkpoints only) instead of the "
                        "offline program")
    p.add_argument("--chunk_frames", type=int, default=10,
                   help="STFT frames per streaming chunk (with "
                        "--streaming; 10 = 62.5 ms at 16 kHz)")
    p.add_argument("--stream_batch", type=int, default=1,
                   help="batch size the streaming artifact is "
                        "specialized to (with --streaming)")
    add_device_arg(p)
    return p


def _refusals(args, seconds):
    """The JAX CLI's refusals, before anything is loaded."""
    if not seconds:
        raise SystemExit("--seconds must name at least one length")
    if args.streaming and seconds != [3.0]:
        # --seconds shapes the offline bucket list only; dropping it
        # silently would let a user believe the streaming artifact was
        # length-specialized
        raise SystemExit("--seconds applies to offline bucket export and "
                         "is ignored by --streaming (chunk size comes from "
                         "--chunk_frames); drop one of the two flags")
    if args.streaming and args.model == "nsvae" and (
            args.outtype != "clean_direct" or args.latent_to_use != 1
            or args.noise_decoder_dir or args.num_samples != 1):
        # StreamingEnhancer computes the clean-direct posterior-mean
        # (z = mu) chunk path; the meta must not claim another program
        raise SystemExit(
            "--streaming exports the clean_direct latent-1 "
            "posterior-mean chunk step; --outtype/--latent_to_use/"
            "--noise_decoder_dir/--num_samples do not apply "
            "(use the offline export for mask out-types)")
    if args.model == "supervised" and not args.model_dir:
        raise SystemExit("--model supervised requires --model_dir")
    if args.model == "nsvae" and not args.nsvae_dir:
        raise SystemExit("--model nsvae requires --nsvae_dir")


def main(argv=None):
    args = build_parser().parse_args(argv)
    from idccrn_vae_torch.device import resolve_device

    device = resolve_device(args.device)
    seconds = [float(s) for s in args.seconds.split(",") if s.strip()]
    _refusals(args, seconds)
    from idccrn_vae_torch.cli.common import (
        config_from_meta,
        load_enhancement_checkpoints,
    )
    from idccrn_vae_torch.eval import export
    from idccrn_vae_torch.train.checkpoint import (
        CheckpointManager,
        datanorm_from_meta,
    )

    meta = {"model": args.model, "fs": args.fs}
    datanorm = None  # supervised only; NSVAE forwards have no datanorm
    if args.model == "supervised":
        from idccrn_vae_torch.models.dccrn import SupervisedDccrn

        ckpt = CheckpointManager(args.model_dir)
        smeta = ckpt.load_meta()
        cfg = enc_cfg = dec_cfg = config_from_meta(smeta)
        datanorm = datanorm_from_meta(smeta)
        enc_state, dec_state = ckpt.load_best(), None
        model = SupervisedDccrn(cfg, datanorm, device=device)
        model.load_state_dict(enc_state)
        serving = export.serving_fn_supervised(model)
    else:
        from idccrn_vae_torch.eval.enhance import Enhancer

        enc_cfg, dec_cfg, enc_state, dec_state, noise_dec_state, pad_mode = \
            load_enhancement_checkpoints(args.nsvae_dir, args.decoder_dir,
                                         args.noise_decoder_dir, args.phase)
        if not args.streaming:
            enhancer = Enhancer(
                enc_cfg, dec_cfg, enc_state, dec_state, noise_dec_state,
                num_samples=args.num_samples, outtype=args.outtype,
                latent_to_use=args.latent_to_use, pad_mode=pad_mode,
                device=device)
            serving = export.serving_fn_nsvae(enhancer)
        cfg = enc_cfg
        meta.update(num_samples=args.num_samples, outtype=args.outtype,
                    phase=args.phase)

    t0 = time.perf_counter()
    if args.streaming:
        from idccrn_vae_torch.eval.streaming import StreamingEnhancer

        if not (enc_cfg.causal and dec_cfg.causal):
            raise SystemExit("--streaming requires a causal checkpoint")
        if args.model == "nsvae":
            meta.pop("num_samples", None)
            meta["latent"] = "posterior_mean"
        streamer = StreamingEnhancer(
            enc_cfg, dec_cfg, enc_state, dec_state,
            chunk_frames=args.chunk_frames, model=args.model,
            datanorm=datanorm, device=device)
        exported, state_spec = export.export_streaming(
            streamer, batch=args.stream_batch)
        hop, n_fft = streamer.hop, streamer.n_fft
        meta.update(
            streaming=True, batch=args.stream_batch,
            chunk_frames=args.chunk_frames,
            chunk_samples=streamer.chunk_samples,
            algorithmic_latency_ms=round(
                (streamer.chunk_samples + n_fft - hop) / args.fs * 1000, 2),
            export_s=round(time.perf_counter() - t0, 3))
        path = export.save_streaming_artifact(args.out_dir, exported,
                                              state_spec, device, meta)
        print(json.dumps({"artifact": path,
                          **{k: v for k, v in meta.items()
                             if k != "state_spec"}}))
        return

    # the serving program emits (frames - 1) * hop samples: hop multiples
    # keep an artifact's output as wide as its input
    hop = cfg.stft.hop
    lengths = sorted({max(hop, (int(s * args.fs) // hop) * hop)
                      for s in seconds})
    meta.update(length=lengths[-1], seconds=lengths[-1] / args.fs,
                n_fft=cfg.stft.n_fft, hop=hop)
    exports = {length: export.export_serving(serving, length, device)
               for length in lengths}
    meta["export_s"] = round(time.perf_counter() - t0, 3)
    path = export.save_artifacts(args.out_dir, exports, serving, device,
                                 meta)
    print(json.dumps({"artifact": path, **meta}))


if __name__ == "__main__":
    main()
