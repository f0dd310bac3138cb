"""Real-time streaming enhancement CLI.

The port of `idccrn_vae_tpu.cli.stream_enhance`, with the same flags
plus --device (default: the CUDA card). It drives the stateful
streaming engine (`eval/streaming.py`) chunk by chunk over wav files,
writes the enhanced output, and reports measured per-chunk latency and
real-time factor. Each chunk's time ends when its output reaches the
host (the `.cpu()` copy waits for the card), and the chunk step is run
once before timing so first-call set-up never lands in a timed chunk.

Examples:
  # phase-1 NSVAE enhancement, 10-frame (62.5 ms) chunks
  python -m idccrn_vae_torch.cli.stream_enhance \
      --nsvae_dir ckpt/nsvae --decoder_dir ckpt/cvae \
      --in_dir noisy/ --out_dir enhanced/

  # supervised DCCRN baseline, on the CPU
  python -m idccrn_vae_torch.cli.stream_enhance --model supervised \
      --model_dir ckpt/dccrn --in_dir noisy/ --out_dir enhanced/ \
      --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from idccrn_vae_torch.cli.common import add_device_arg


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", type=str, default="nsvae",
                   choices=["nsvae", "supervised"])
    p.add_argument("--nsvae_dir", type=str, default=None,
                   help="NSVAE checkpoint dir (phase 1) or phase-2 dir")
    p.add_argument("--decoder_dir", type=str, default=None,
                   help="pretrained CVAE decoder dir (phase 1)")
    p.add_argument("--phase", type=int, default=1, choices=[1, 2])
    p.add_argument("--model_dir", type=str, default=None,
                   help="supervised DCCRN checkpoint dir (--model supervised)")
    p.add_argument("--in_dir", type=str, default=None)
    p.add_argument("--in_wav", type=str, default=None)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--chunk_frames", type=int, default=10,
                   help="STFT frames per chunk (10 = 62.5 ms at 16 kHz); "
                        "algorithmic latency = chunk + 25.75 ms")
    p.add_argument("--fs", type=int, default=16000)
    add_device_arg(p)
    return p


def _load_streaming_models(args):
    """(enc_cfg, dec_cfg, enc_state, dec_state, datanorm); for the
    supervised model enc_state is its one state_dict and dec_state
    None, as `StreamingEnhancer` takes them."""
    from idccrn_vae_torch.cli.common import (
        config_from_meta,
        load_enhancement_checkpoints,
    )

    if args.model == "supervised":
        if not args.model_dir:
            raise SystemExit("--model supervised requires --model_dir")
        from idccrn_vae_torch.train.checkpoint import (
            CheckpointManager,
            datanorm_from_meta,
        )

        ckpt = CheckpointManager(args.model_dir)
        meta = ckpt.load_meta()
        cfg = config_from_meta(meta)
        return cfg, cfg, ckpt.load_best(), None, datanorm_from_meta(meta)

    if not args.nsvae_dir:
        raise SystemExit("--model nsvae requires --nsvae_dir")
    enc_cfg, dec_cfg, enc_state, dec_state, _noise, _pad = \
        load_enhancement_checkpoints(args.nsvae_dir, args.decoder_dir,
                                     phase=args.phase)
    # NSVAE noisy encoders never apply datanorm (reference parity)
    return enc_cfg, dec_cfg, enc_state, dec_state, None


def main(argv=None):
    args = build_parser().parse_args(argv)
    from idccrn_vae_torch.device import resolve_device

    device = resolve_device(args.device)
    if bool(args.in_dir) == bool(args.in_wav):
        raise SystemExit("pass exactly one of --in_dir / --in_wav")

    from idccrn_vae_torch.data.audio_io import read_wav, resample, write_wav
    from idccrn_vae_torch.data.segments import find_wavs
    from idccrn_vae_torch.eval.streaming import StreamingEnhancer

    # resolve inputs BEFORE loading/warming the model: an empty --in_dir
    # must fail with a clear message, not an opaque np.percentile
    # IndexError after the model is built
    paths = [args.in_wav] if args.in_wav else find_wavs(args.in_dir)
    if not paths:
        raise SystemExit(f"no wav files found in --in_dir {args.in_dir}")

    enc_cfg, dec_cfg, enc_state, dec_state, datanorm = \
        _load_streaming_models(args)
    if not (enc_cfg.causal and dec_cfg.causal):
        raise SystemExit("streaming requires a causal checkpoint "
                         "(this one was trained non-causal)")
    streamer = StreamingEnhancer(enc_cfg, dec_cfg, enc_state, dec_state,
                                 chunk_frames=args.chunk_frames,
                                 model=args.model, datanorm=datanorm,
                                 device=device)
    m = streamer.chunk_samples
    chunk_s = m / args.fs

    os.makedirs(args.out_dir, exist_ok=True)

    # Run the chunk step once so first-call set-up (cuDNN algorithm
    # choice, allocator growth) never lands in a timed chunk — otherwise
    # a file that fits in a single chunk would report its set-up as
    # latency and realtime_capable=false for a model that keeps up.
    warm_state = streamer.init_state(1)
    streamer.process_chunk(warm_state, np.zeros((1, m), np.float32))[0].cpu()

    chunk_times = []
    total_audio = 0.0
    t_all = time.perf_counter()
    for path in paths:
        wav, fs = read_wav(path)
        if wav.ndim > 1:
            wav = wav[:, 0]
        if fs != args.fs:
            wav = resample(wav, fs, args.fs)
        n_chunks = max(1, -(-len(wav) // m))  # ceil; zero-pad the tail
        padded = np.zeros(n_chunks * m, np.float32)
        padded[: len(wav)] = wav
        state = streamer.init_state(1)
        outs = []
        for k in range(n_chunks):
            t0 = time.perf_counter()
            out, state = streamer.process_chunk(
                state, padded[None, k * m:(k + 1) * m])
            out = out.cpu().numpy()  # waits for the card
            chunk_times.append(time.perf_counter() - t0)
            outs.append(out[0])
        enhanced = np.concatenate(outs)[: len(wav)]
        write_wav(os.path.join(args.out_dir, os.path.basename(path)),
                  enhanced, args.fs)
        total_audio += len(wav) / args.fs
    wall = time.perf_counter() - t_all

    # Every timed chunk follows the warm-up call, so the percentiles are
    # steady-state latency.
    steady = np.asarray(sorted(chunk_times))
    report = {
        "files": len(paths),
        "audio_s": round(total_audio, 3),
        "wall_s": round(wall, 3),
        "rtf_x": round(total_audio / wall, 2),
        "chunk_ms": round(chunk_s * 1000, 2),
        "algorithmic_latency_ms": round(
            chunk_s * 1000 + (streamer.n_fft - streamer.hop) / args.fs * 1000,
            2),
        "chunk_p50_ms": round(float(np.percentile(steady, 50)) * 1000, 2),
        "chunk_p95_ms": round(float(np.percentile(steady, 95)) * 1000, 2),
        "realtime_capable": bool(np.percentile(steady, 95) < chunk_s),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
