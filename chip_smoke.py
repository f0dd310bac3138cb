"""Drive the PyTorch port's serving path on one CUDA card and check it.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py [--trace-dir DIR]

It exercises `idccrn_vae_torch` through its serving entry points
(`Enhancer.forward`, `enhance_utterances`, `enhance_batch`) at the full
reference width (channels 1-32-64-128-128-256-256, zdim 128, causal,
16 kHz, num_samples 1), with random weights drawn from a seeded CPU
generator. Phases, one summary line each:

  device      the card's name, and its name and power limit as nvidia-smi
              reports them
  f32         Enhancer.forward on the card against the same forward on
              the CPU, same weights and latent draws, TF32 off
  bf16        compute='bf16' on the card against the f32 card output
  serving     enhance_utterances on 12 requests of 0.5-6 s (two buckets)
  throughput  enhance_batch at bf16 on 3 s clips, B = 32 and 128, each
              input chained from the previous output
  trace       torch.profiler over one bf16 forward at B=32, then at
              B=128: the top device ops by self time and the device
              launches per forward

The port has no hand-written kernel yet: every op of the path is a
PyTorch op (cuDNN convolution, cuBLAS matmul, cuFFT, elementwise), so
the kernel table it prints is empty.

It exits non-zero, and prints no result, when any phase fails or no
CUDA device is visible. The last line of its output is one JSON object
naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
FS = 16000
CLIP_S = 3
# Card against CPU at f32 with TF32 off: both sides are float32 with
# summation orders of their own (cuDNN/cuBLAS against oneDNN/MKL), so
# the error is a few float32 roundings, amplified by the 12 stages and
# the 481-step recurrence. Bound: max |card - cpu| <= F32_REL * max |cpu|.
F32_REL = 1e-4
# bf16 against f32 on the card: bf16 operands and activations keep 8
# mantissa bits, so each of the ~14 stages adds ~2**-9 relative
# rounding. Bound on ||bf16 - f32||_2 / ||f32||_2.
BF16_REL_L2 = 5e-2
THROUGHPUT_BATCHES = (32, 128)


def _line(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"{phase}: {body}", flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def _config(compute: str):
    from idccrn_vae_torch.models.config import DccrnConfig

    return DccrnConfig(causal=True, num_samples=1, latent_num=1, zdim=128,
                       compute=compute)


def _weights(cfg):
    """Seeded random weights as state_dicts (drawn on the CPU)."""
    from idccrn_vae_torch.models.nsvae import NsvaeEncoder
    from idccrn_vae_torch.models.vae import VaeDecoder

    enc = NsvaeEncoder(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(SEED))
    dec = VaeDecoder(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(SEED + 1))
    return enc.state_dict(), dec.state_dict()


def _enhancer(compute: str, weights, device: str):
    from idccrn_vae_torch.eval.enhance import Enhancer

    cfg = _config(compute)
    return Enhancer(cfg, cfg, *weights, num_samples=1, device=device)


def phase_device(device: str) -> str:
    name = torch.cuda.get_device_name(device)
    smi = _nvidia_smi()
    _line("device", torch=torch.__version__, cuda=torch.version.cuda,
          name=json.dumps(name), count=torch.cuda.device_count())
    print(f"nvidia-smi name,power.limit: {smi}", flush=True)
    return smi


def phase_f32(weights, device: str):
    """Full-width forward on the card against the CPU, TF32 off."""
    gen = torch.Generator().manual_seed(SEED + 2)
    b, n = 2, CLIP_S * FS
    wav = 0.1 * torch.randn(b, n, generator=gen)
    cfg = _config("f32")
    frames = n // cfg.stft.hop + 1
    noise = tuple(torch.randn(b, 1, frames, cfg.zdim, generator=gen)
                  for _ in range(2))
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _enhancer("f32", weights, device).forward(wav.to(device),
                                                     noise=noise)
    torch.cuda.synchronize()
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
    cpu = _enhancer("f32", weights, "cpu").forward(wav, noise=noise)
    got = card.cpu()
    _check(got.shape == cpu.shape == (b, n), f"f32 shape {tuple(got.shape)}")
    _check(bool(torch.isfinite(got).all()), "f32 output is not finite")
    err = (got - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    _line("f32", tf32="off", batch=b, seconds=CLIP_S,
          max_abs_err=f"{err:.3e}", max_abs_out=f"{scale:.3e}",
          rel_err=f"{err / scale:.3e}", tol=F32_REL)
    _check(err <= F32_REL * scale, f"f32 card vs cpu rel err {err / scale}")
    return wav, noise, card


def phase_bf16(weights, device: str, wav, noise, ref) -> None:
    out = _enhancer("bf16", weights, device).forward(wav.to(device),
                                                     noise=noise)
    _check(out.dtype == torch.float32 and out.shape == ref.shape,
           "bf16 output shape/dtype")
    _check(bool(torch.isfinite(out).all()), "bf16 output is not finite")
    rel = ((out - ref).norm() / ref.norm()).item()
    _line("bf16", vs="f32 on the card", rel_l2=f"{rel:.3e}",
          bound=BF16_REL_L2)
    _check(rel <= BF16_REL_L2, f"bf16 rel L2 {rel}")


def phase_serving(enh) -> None:
    rng = np.random.default_rng(SEED + 3)
    lengths = rng.integers(FS // 2, 6 * FS, size=12)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in lengths]
    batch_size = 8
    gen = enh.new_generator(SEED)
    t0 = time.perf_counter()
    outs = enh.enhance_utterances(wavs, batch_size=batch_size, generator=gen)
    cold = time.perf_counter() - t0
    for w, o in zip(wavs, outs):
        _check(o.shape == w.shape, f"serving length {o.shape} != {w.shape}")
        _check(bool(np.isfinite(o).all()), "serving output is not finite")
    # time each batch as enhance_utterances forms it: sorted, batch_size
    # at a time, each batch padded to one bucket
    order = np.argsort(lengths)
    buckets, timings = set(), []
    for i in range(0, len(order), batch_size):
        chunk = [wavs[j] for j in order[i : i + batch_size]]
        bucket = enh.bucket_length(max(len(w) for w in chunk))
        buckets.add(bucket)
        t0 = time.perf_counter()
        enh.enhance_utterances(chunk, batch_size=batch_size, generator=gen)
        ms = 1e3 * (time.perf_counter() - t0)
        timings.append(f"{bucket / FS:g}s:{len(chunk)}req:{ms:.1f}ms")
    _check(len(buckets) >= 2, "serving used fewer than two buckets")
    _line("serving", requests=len(wavs), compute="bf16",
          audio_s=f"{sum(lengths) / FS:.2f}", first_call_s=f"{cold:.3f}",
          warm_per_bucket=",".join(timings))


def phase_throughput(enh, device: str, smi: str, iters: int = 20) -> None:
    n = CLIP_S * FS
    gen = enh.new_generator(SEED)
    for b in THROUGHPUT_BATCHES:
        wav = 0.1 * torch.randn(b, n, device=device, generator=gen)
        torch.cuda.reset_peak_memory_stats(device)
        out = wav
        for _ in range(3):  # warm-up: cuDNN plans, allocator
            out = enh.enhance_batch(wav + 1e-6 * out, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = enh.enhance_batch(wav + 1e-6 * out, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check(bool(torch.isfinite(out).all()), "throughput output")
        peak = torch.cuda.max_memory_allocated(device)
        _line("throughput", batch=b, compute="bf16", num_samples=1,
              clip_s=CLIP_S, iters=iters,
              rtfx=f"{iters * b * CLIP_S / dt:.1f}",
              ms_per_batch=f"{1e3 * dt / iters:.2f}",
              peak_mem_gib=f"{peak / 2**30:.3f}", card=json.dumps(smi))


def phase_trace(enh, device: str, trace_dir, b: int, top: int = 10) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = CLIP_S * FS
    gen = enh.new_generator(SEED)
    wav = 0.1 * torch.randn(b, n, device=device, generator=gen)
    enh.enhance_batch(wav, gen)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enh.enhance_batch(wav, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in dev)
    busy_us = sum(e.self_device_time_total for e in dev)
    cpu_launch = sum(e.count for e in prof.key_averages()
                     if e.key.startswith("cudaLaunchKernel"))
    _line("trace", batch=b, compute="bf16", wall_ms=f"{1e3 * wall:.2f}",
          device_ops=launches, cuda_launch_kernel_calls=cpu_launch,
          device_busy_ms=f"{busy_us / 1e3:.2f}",
          busy_share=f"{busy_us / 1e6 / wall:.3f}")
    _check(launches > 0 and busy_us > 0,
           "the profiler recorded no device time")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:110]}", flush=True)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        stem = os.path.join(trace_dir, f"trace_b{b}_bf16")
        prof.export_chrome_trace(stem + ".json")
        with open(stem + ".txt", "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=80))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-dir", default=None,
                    help="also write the profiler trace and table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs "
              "only on the card", file=sys.stderr)
        return 2
    device = "cuda"
    t_start = time.perf_counter()
    smi = phase_device(device)
    weights = _weights(_config("f32"))
    wav, noise, ref = phase_f32(weights, device)
    phase_bf16(weights, device, wav, noise, ref)
    enh = _enhancer("bf16", weights, device)
    phase_serving(enh)
    phase_throughput(enh, device, smi)
    for b in THROUGHPUT_BATCHES:
        phase_trace(enh, device, args.trace_dir, b)
    # no hand-written kernel is on this path yet
    print(json.dumps({"kernels": []}))
    _line("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
