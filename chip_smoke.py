"""Drive the PyTorch port's serving, evaluation and training paths on one
CUDA card and check them.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py [--trace-dir DIR] [--only serving|eval|train|
                          fullwidth|tools|utils|quickstart|cmgan|lstm]

It exercises `idccrn_vae_torch` through its entry points at the full
reference width (channels 1-32-64-128-128-256-256, zdim 128, causal,
16 kHz), with random weights drawn from seeded CPU generators. Phases,
one summary line each:

  device           the card's name, and its name and power limit as
                   nvidia-smi reports them
  f32              Enhancer.forward (clean_direct, num_samples 1) on the
                   card against the same forward on the CPU, same weights
                   and latent draws, TF32 off
  bf16             compute='bf16' on the card against the f32 card output
  serving          enhance_utterances on 12 requests of 0.5-6 s (two
                   buckets)
  throughput       enhance_batch at bf16 on 3 s clips, B = 32 and 128,
                   each input chained from the previous output
  trace            torch.profiler over one bf16 forward at B=32, then at
                   B=128: the top device ops by self time and the device
                   launches per forward
  dual_f32         the dual-latent program (latent_num=2 double-channel
                   encoder, speech and noise decoders): each mask
                   out-type on the card against the CPU, TF32 off
  dual_bf16        complex_mask at bf16 against f32 on the card
  dual_throughput  enhance_batch of the dual program at bf16, B = 32 and
                   128, chained inputs, and a profiler top-10 at B=32
  streaming        StreamingEnhancer (10-frame chunks, 62.5 ms), 3 s, B=1
                   and B=32: card against CPU, against the offline causal
                   z = mu forward, and per-chunk wall time
  supervised       SupervisedDccrn (causal, mask, datanorm) card against
                   CPU and bf16 against f32, its RTFx at B=32,
                   LegacyDccrn card against CPU, and the supervised
                   streamer card against CPU
  vae_recon        VaeEncoder -> VaeDecoder (num_samples 5, zero skips,
                   datanorm) card against CPU
  dnsmos           the five DNSMOS graphs on the card (eval/onnx_exec.py's
                   torch runner) on the golden signal and on seeded
                   noise against the numpy executor on the CPU, 1e-4 of
                   max |out| per output, TF32 left on around the runner
                   (which turns it off for its run) and, for contrast,
                   the error with TF32 on; every node output on the
                   card; score_array's raw scores against the pinned
                   goldens; warm ms per 9.01 s window
  int8             compute='int8' at quant_scope 'enc' and 'all': each
                   quantized conv's int8 operands and int32 accumulator
                   on the card against the CPU from the same input, bit
                   for bit; the output against f32 on the card; RTFx at
                   B=32 and 128 beside bf16's (int8_throughput); each
                   quantized conv at B=32, quantize + im2col + _int_mm +
                   dequantize against the bf16 cuDNN conv (int8_stage)
  export           torch.export of clean_direct (bf16, 0.5 s) on the card,
                   timed; the artifact against the eager program with the
                   same latent draws at B=1 and 32; RTFx of both in
                   turns; an f32 export (0.25 s) against eager, TF32 off;
                   the streaming artifact against StreamingEnhancer over
                   144 chunks (export_stream)

The evaluation entry points, on a corpus of 24 utterances of 1.5-6 s from
`data/synth.make_corpus` (four SNR buckets), with the weights above
written as port checkpoint dirs (meta.json + best.pt) in a temp dir;
each CLI runs on its default device, the card:

  eval_cli         cli.test_enhance, phase 1, --compute bf16, num_samples
                   10, batch 8, --write_wavs --corpus_meta: every score
                   finite, each wav equal to Enhancer.enhance_utterances
                   (same seed) to one PCM16 step; the wall-time split
                   (load, enhance, score enhanced, score noisy), RTFx of
                   the enhance part and of the whole CLI
  dnsmos_cli       cli.dnsmos on the card over eval_cli's wavs, with a
                   CSV: each row against the torch runner on the CPU,
                   every score to 1e-4 relative; wall per file
  prevae_cli       cli.test_prevae over the clean split, num_samples 10:
                   finite scores and the latent_diag keys
  supervised_cli   cli.test_supervised: each wav equal to SupervisedDccrn
                   over the runner's batches to one PCM16 step
  stream_cli       cli.stream_enhance over 4 files: each wav equal to
                   StreamingEnhancer.stream to one PCM16 step; the CLI's
                   report
  export_cli       cli.export_model (one 0.5 s bucket) then
                   cli.run_artifact over the corpus: each wav equal, to
                   one PCM16 step, to the same windowing of the eager
                   Enhancer with the same latent draws
  eval_cli_int8    cli.test_enhance --compute int8: finite scores, the
                   CLI's RTFx

The scores come from random weights and say nothing of enhancement
quality.

Training, at the configs' inis (3 s segments of 481 frames):

  pretrain_step    one f32 CVAE step (configs/pretrained_cvae.ini's usage
                   line: num_samples 5, zero skips) at B=2 on the card
                   against the CPU, TF32 off, same weights, batch and
                   latent draws: the loss and every parameter's gradient,
                   beside the spread between two card runs; then 4 warm
                   Adam steps at B=16, f32 and bf16: ms per step,
                   segments per second, peak memory
  train_trace      torch.profiler over one warm f32 CVAE step at B=16:
                   top kernels, device time by aten op, device ops per
                   step, busy share
  nsvae_step       the same for NsvaeTrainer (latent_num 2, original
                   channels, frozen encoders unchanged), timed at B=24
  phase2_step      the same for Phase2Trainer, classical
                   (configs/two_phase_training.ini's usage line,
                   latent_num 2: both decoders, the frozen encoder
                   unchanged), timed at B=16
  adv_step         the same with --adversarial --d_step 1: the G and D
                   losses, the decoder's and D's gradients; timed at
                   B=16, f32
  adv_trace        torch.profiler over one warm adversarial step at B=16
  supervised_step  the same for SupervisedTrainer (configs/
                   supervised_dccrn.ini's usage line with datanorm), B=16
  train_cli        on a synth corpus of 16 train and 12 val utterances of
                   6.5 s, with the three inis pointed at it: train_vae on
                   clean speech and on noise, train_nsvae against both
                   (2 epochs each), train_nsvae resumed for a third
                   epoch, then test_enhance --phase 1 on the runs; finite
                   losses and scores, the epoch counters, each CLI's wall
                   time
  train2_cli       on the same corpus and runs: cal_mean_std,
                   train_supervised --data_norm, train_phase2 classical
                   (--load_de) and --adversarial, the adversarial run
                   resumed, test_enhance --phase 2, test_supervised
  ddp              data parallelism: world 2 on Gloo with CUDA tensors,
                   both ranks on this card (NCCL refuses two ranks on
                   one device), spawned here; one f32 step of each
                   trainer at its ini's batch (pretraining with the MI
                   term) against the same step in one process: losses,
                   gradients, BN statistics and counters; ms per step of
                   both (not a scaling figure)
  remat            cfg.remat: a CVAE step at B=16 with remat on against
                   off (loss, gradients, BN statistics, counters at 1),
                   then ms per step and peak memory of each
  ddp_cli          train_vae (2 epochs) under a one-rank NCCL group
                   joined from the torchrun environment, its curves
                   against train_cli's plain run; train_vae --n_devices 2
                   without a group, which resolves to world 1 here

Each trainer's step at bf16 held against its f32 step:

  fullwidth_bf16_step  the six train cases of port_tools/fullwidth_parity.py
                   (CVAE with zero and with real skips, the NSVAE, phase 2
                   classical and adversarial, the supervised DCCRN) at
                   DccrnConfig()'s widths, bf16 and f32 (TF32 off) from the
                   same weights and draws: each loss's and each trained
                   model's whole-gradient distance of bf16 from f32 beside
                   the JAX package's bf16 distance that
                   FULLWIDTH_PARITY_TORCH.json recorded on the CPU; at the
                   tool's batch and segment held to its YARD_RATIO times
                   the port's distance on this host's CPU (same weights
                   and draws) plus YARD_FLOOR, at the ini's batch of 3 s
                   segments printed

The measurement tools (`idccrn_vae_torch/tools/`), each at the full
reference width with the shortened counts TOOL_ARGS gives (the reports
record them):

  tools_bench      bench's clean_direct program at f32 (TF32 off) with
                   the f32 phase's weights and latent draws, against that
                   phase's Enhancer output to 1e-4 of max |out|; then
                   tools.bench (clean_direct bf16 and int8, the dual
                   program bf16, B = 32 and 128)
  tools_train      tools.train_bench: all 13 configurations 'ok'
  tools_stream     tools.stream_bench: the five chunk configurations and
                   the LSTM probe
  tools_decoder    tools.profile_decoder: the sub-pixel check of every
                   stage passed, the useful MFU in (0, 1]
  tools_profile    tools.profile_train: every program's MFU in (0, 1],
                   the decoder's counted FLOPs against the analytic count
  tools_phases     their total time
Every number of every report finite; every busy share in (0, 1].

The utilities and the quickstart:

  utils_trace      utils/profiling.trace around one bf16 clean_direct
                   forward at B=32: the Chrome trace holds CUDA kernel
                   events
  utils_timer      StepTimer over 10 such forwards, each stopped by
                   block_and_stop on its output
  utils_memory     log_memory: the host's RSS, the card's bytes in use
                   and peak (> 0)
  utils_debug      check_finite over the Enhancer's weights;
                   checkify_finite on a card tensor holding a NaN raises,
                   and the card still runs afterwards
  quickstart       idccrn_vae_torch.examples.quickstart on the card in a
                   temp dir: every stage's checkpoint dir, finite scores,
                   the streamed wav; each stage's seconds

CMGAN's generator (`--only cmgan`; `models/cmgan.py`, the CUDA kernel
`rel_attn_fwd` of `ops/rel_attention.py`):

  cmgan_kernel     the kernel against its plain path at the benchmark
                   cell's shapes, bf16, q, k, v strided as the model
                   makes them: the time axis, 808 rows of 2600 frames
                   with key lengths drawn in [1, 2600], and the
                   frequency axis, 20800 rows of 101 unmasked; relative
                   L2 within CMGAN_KERNEL_REL_L2; ms alone (CUDA events)
                   beside the plain path's and the bound
  cmgan_serve      CmganEnhancer at the published widths, bf16, on 8
                   utterances of 16 s and 8 of 6 s (buckets of 2600 and
                   1000 frames, two batches): every answer finite and of
                   its length, the kernel launched 8 times a batch
                   (launch count zeroed just before), RTFx

The LSTM recurrence kernel (`--only lstm`; `csrc/lstm_recurrence.cu`,
launched by `ops/lstm.py` `_layer` on the card with no grad):

  lstm_kernel      the kernel against the eager step loop at the
                   benchmark cells' layer calls: z128 eval (S 2, N 16,
                   H 384, T 1701, bf16), dual (H 768), serve (N 256, T
                   501) and stream (N 2, T 10, float32, a carried state),
                   then the float32 dual program at N 256, T 501;
                   out and the final h and c within LSTM_KERNEL_REL_L2;
                   ms of the kernel, of the loop and of cuDNN's
                   torch.nn.LSTM at bf16 over the same frames and rows
                   (a yardstick only: the port never calls it)
  lstm_enhancer    one bf16 Enhancer batch of 8 x 10 s at full width
                   with the counters zeroed: one launch per layer of
                   each ComplexLSTM call, no step of the eager loop

`--only serving|eval|train|fullwidth|tools|utils|quickstart|cmgan|lstm`
runs one group of phases (eval brings serving along: the CLIs read its
weights).

Two hand-written kernels are on these paths, CUDA C++ built with nvcc at
their first use: CMGAN's relative-position attention, `rel_attn_fwd`,
and the LSTM recurrence, `lstm_recurrence`. Every other op is a PyTorch
op (cuDNN convolution, cuBLAS matmul and the int8 product
`torch._int_mm`, cuFFT, elementwise, and autograd's backward of each).
The `kernels` line lists each kernel at each shape its group ran: ms,
the bound, the plain path's ms and `library_ms`. The attention's bound
is the larger of its FLOPs, 6 n_q n_k d per row and head over the real
keys, at 989.4 TFLOP/s, and its bytes, q, k, v and the answer once and
the table once, at 3.35 TB/s; its `library_ms` is null: no PyTorch call
computes a q-dependent relative term (SDPA takes only a bias built
beforehand). The LSTM's bound is the larger of its recurrent product,
S N 4H H 2 T FLOPs, at 989.4 TFLOP/s (bf16) or 66.9 (float32, FFMA),
and its bytes, xp, w_hh, the carry, out and the final c once, at 3.35
TB/s; its `library_ms` is cuDNN's LSTM.

It exits non-zero, and prints no result, when any phase fails or no
CUDA device is visible. The last line of its output is one JSON object
naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
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
MASKS = ("real_imag_mask", "complex_mask", "phase_mask")
STREAM_CHUNK_FRAMES = 10  # 1000 samples, 62.5 ms
STREAM_BATCHES = (1, 32)
# the offline forward's frames sit n_fft/2 ahead of the signal, the
# stream's n_fft - hop: shift the offline input by the difference and
# drop the stream's first n_fft/2 samples (tests/test_streaming.py)
STREAM_SHIFT = (512 - 100) - 256
STREAM_DELAY = 256


def _line(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"{phase}: {body}", flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


class _NoTf32:
    """TF32 off for cuDNN and cuBLAS inside the block (card-vs-CPU
    comparisons hold float32 against float32)."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


def _max_rel(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, max |ref|), both on the host."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return (got - ref).abs().max().item(), ref.abs().max().item()


def _check_close(phase: str, got: torch.Tensor, ref: torch.Tensor,
                 rel: float, **fields) -> float:
    """Finite, same shape, max |got - ref| <= rel * max |ref|; one line."""
    _check(tuple(got.shape) == tuple(ref.shape),
           f"{phase} shape {tuple(got.shape)} != {tuple(ref.shape)}")
    _check(bool(torch.isfinite(got).all()), f"{phase} output is not finite")
    err, scale = _max_rel(got, ref)
    _line(phase, **fields, max_abs_err=f"{err:.3e}",
          max_abs_out=f"{scale:.3e}", rel_err=f"{err / scale:.3e}", tol=rel)
    _check(err <= rel * scale, f"{phase} rel err {err / scale}")
    return err / scale


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


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
    with _NoTf32():
        card = _enhancer("f32", weights, device).forward(wav.to(device),
                                                         noise=noise)
        torch.cuda.synchronize()
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


def phase_throughput(enh, device: str, smi: str, iters: int = 20,
                     phase: str = "throughput", **fields) -> None:
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
        _line(phase, **fields, batch=b, compute=enh.enc_cfg.compute,
              num_samples=1,
              clip_s=CLIP_S, iters=iters,
              rtfx=f"{iters * b * CLIP_S / dt:.1f}",
              ms_per_batch=f"{1e3 * dt / iters:.2f}",
              peak_mem_gib=f"{peak / 2**30:.3f}", card=json.dumps(smi))


def _profiled(phase: str, run, trace_dir, stem: str, top: int = 10,
              **fields):
    """torch.profiler over one call of `run` (warm), closed by a
    synchronize: device ops, launch calls, device busy share, and the
    top device ops by self time. Returns the profile's key averages
    (built once: on a ~100k-op step each build takes tens of seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    dev = [e for e in averages if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in dev)
    busy_us = sum(e.self_device_time_total for e in dev)
    cpu_launch = sum(e.count for e in averages
                     if e.key.startswith("cudaLaunchKernel"))
    _line(phase, **fields, wall_ms=f"{1e3 * wall:.2f}",
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
        path = os.path.join(trace_dir, stem)
        prof.export_chrome_trace(path + ".json")
        with open(path + ".txt", "w") as f:
            f.write(averages.table(sort_by="self_device_time_total",
                                   row_limit=80))
    return averages


def phase_trace(enh, device: str, trace_dir, b: int, top: int = 10,
                phase: str = "trace") -> None:
    n = CLIP_S * FS
    gen = enh.new_generator(SEED)
    wav = 0.1 * torch.randn(b, n, device=device, generator=gen)
    enh.enhance_batch(wav, gen)  # warm
    torch.cuda.synchronize()
    _profiled(phase, lambda: enh.enhance_batch(wav, gen), trace_dir,
              f"{phase}_b{b}_bf16", top, batch=b, compute="bf16")


# ------------------------------------------------------------ dual latent


def _dual_configs(compute: str):
    """The bench.py dual program: latent_num=2 double-channel encoder,
    speech and noise decoders at the pretrain geometry."""
    import dataclasses

    from idccrn_vae_torch.models.config import DccrnConfig

    enc = DccrnConfig(causal=True, num_samples=1, latent_num=2,
                      channel_mode="double", zdim=128, compute=compute)
    return enc, dataclasses.replace(enc, latent_num=1, channel_mode="normal")


def _dual_weights():
    from idccrn_vae_torch.models.nsvae import NsvaeEncoder
    from idccrn_vae_torch.models.vae import VaeDecoder

    enc_cfg, dec_cfg = _dual_configs("f32")
    seeded = lambda k: torch.Generator().manual_seed(SEED + k)
    enc = NsvaeEncoder(enc_cfg, device="cpu", generator=seeded(10))
    decs = [VaeDecoder(dec_cfg, device="cpu", generator=seeded(k))
            for k in (11, 12)]
    return enc.state_dict(), decs[0].state_dict(), decs[1].state_dict()


def _dual_enhancer(compute: str, weights, device: str, outtype: str):
    from idccrn_vae_torch.eval.enhance import Enhancer

    enc_cfg, dec_cfg = _dual_configs(compute)
    return Enhancer(enc_cfg, dec_cfg, *weights, num_samples=1,
                    outtype=outtype, latent_to_use=2, device=device)


@torch.inference_mode()
def _dual_spectra(enh, wav, eps):
    """(speech spectrum, noise spectrum, noisy spectrum), each
    (B, F, T, 2), through the Enhancer's own modules."""
    from idccrn_vae_torch.models.nsvae import split_noisy_skips

    out = enh.encoder(wav, num_samples=1, noise=eps[0], noise_n=eps[1])
    s = enh.decoder(out.stft_x, out.z_speech,
                    split_noisy_skips(out.skips, enh.enc_cfg, "speech"),
                    num_samples=1)[1]
    n = enh.noise_decoder(out.stft_x, out.z_noise,
                          split_noisy_skips(out.skips, enh.enc_cfg, "noise"),
                          num_samples=1)[1]
    return s.cpu(), n.cpu(), out.stft_x.cpu()


def _combined(outtype: str, spec, device: str) -> torch.Tensor:
    """combine_outputs + ISTFT of (speech, noise, noisy) spectra on
    `device`: the end of the dual program."""
    from idccrn_vae_torch.eval.enhance import combine_outputs
    from idccrn_vae_torch.ops.stft import istft

    s, n, y = (x.to(device) for x in spec)
    return istft(combine_outputs(outtype, s, n, y, 1))


def _worst_bin(phase: str, outtype: str, spec, ref_spec) -> None:
    """Where the masked estimates from two sets of spectra differ most:
    the bin, its |S|, |N| and |S + N|, and the smallest
    |S + N| / (|S| + |N|) over all bins (how close the complex ratio
    S / (S + N) comes to a pole)."""
    from idccrn_vae_torch.eval.enhance import combine_outputs

    est = [combine_outputs(outtype, x[0], x[1], x[2], 1)
           for x in (spec, ref_spec)]
    diff = (est[0] - est[1]).norm(dim=-1)
    b, f, t = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    s, n = (torch.view_as_complex(x.contiguous()) for x in ref_spec[:2])
    cond = (s + n).abs() / (s.abs() + n.abs() + 1e-30)
    _line(phase + "_bins", outtype=outtype,
          est_max_abs_diff=f"{diff.max().item():.3e}",
          est_max_abs=f"{est[1].norm(dim=-1).max().item():.3e}",
          worst_bin=f"b{b}/f{f}/t{t}",
          abs_s=f"{s[b, f, t].abs().item():.3e}",
          abs_n=f"{n[b, f, t].abs().item():.3e}",
          abs_s_plus_n=f"{(s + n)[b, f, t].abs().item():.3e}",
          cond_at_worst=f"{cond[b, f, t].item():.3e}",
          min_cond=f"{cond.min().item():.3e}")


def phase_dual_f32(weights, device: str):
    """The dual program on the card against the CPU, TF32 off.

    Held: both decoders' spectra (the input of the mask combination),
    the combination + ISTFT on the card against the CPU from the same
    spectra, and the end-to-end output of the bounded masks
    (real_imag_mask in [0, 1], phase_mask in [-1, 1]). complex_mask's
    S / (S + N) has a pole where S is close to -N: with random weights a
    few bins come within ~1e-2 of it and multiply the spectra's
    float32 differences by ~1e2, so its end-to-end error is printed,
    with the worst bin, and not held.
    """
    gen = torch.Generator().manual_seed(SEED + 13)
    b, n = 2, CLIP_S * FS
    wav = 0.1 * torch.randn(b, n, generator=gen)
    frames = n // 100 + 1
    eps = [tuple(torch.randn(b, 1, frames, 128, generator=gen)
                 for _ in range(2)) for _ in range(2)]  # speech, noise
    with _NoTf32():
        card_spec = _dual_spectra(
            _dual_enhancer("f32", weights, device, "complex_mask"),
            wav.to(device), eps)
    cpu_spec = _dual_spectra(
        _dual_enhancer("f32", weights, "cpu", "complex_mask"), wav, eps)
    for name, c, r in zip(("speech", "noise"), card_spec, cpu_spec):
        _check_close("dual_f32", c, r, F32_REL, spectrum=name, vs="cpu",
                     tf32="off", batch=b, seconds=CLIP_S)
    outs = {}
    for outtype in MASKS:
        _check_close("dual_f32", _combined(outtype, cpu_spec, device),
                     _combined(outtype, cpu_spec, "cpu"), F32_REL,
                     outtype=outtype, part="combine+istft", vs="cpu")
        _worst_bin("dual_f32", outtype, card_spec, cpu_spec)
        with _NoTf32():
            card = _dual_enhancer("f32", weights, device, outtype).forward(
                wav.to(device), noise=eps[0], noise_n=eps[1])
            torch.cuda.synchronize()
        cpu = _dual_enhancer("f32", weights, "cpu", outtype).forward(
            wav, noise=eps[0], noise_n=eps[1])
        if outtype == "complex_mask":
            err, scale = _max_rel(card, cpu)
            _check(bool(torch.isfinite(card).all()), "dual_f32 not finite")
            _line("dual_f32", outtype=outtype, part="end_to_end", vs="cpu",
                  max_abs_err=f"{err:.3e}", max_abs_out=f"{scale:.3e}",
                  rel_err=f"{err / scale:.3e}", held="no (pole bins)")
        else:
            _check_close("dual_f32", card, cpu, F32_REL, outtype=outtype,
                         part="end_to_end", vs="cpu", tf32="off")
        outs[outtype] = card
    return wav, eps, card_spec, outs


def phase_dual_bf16(weights, device: str, wav, eps, f32_spec, f32_outs):
    """bf16 against f32 on the card. Held: the two decoders' spectra and
    the bounded masks' outputs, rel L2 <= BF16_REL_L2; complex_mask's
    output is printed with its worst bin (see phase_dual_f32)."""
    for outtype in MASKS:
        enh = _dual_enhancer("bf16", weights, device, outtype)
        out = enh.forward(wav.to(device), noise=eps[0], noise_n=eps[1])
        ref = f32_outs[outtype]
        _check(out.dtype == torch.float32 and out.shape == ref.shape,
               "dual bf16 output shape/dtype")
        _check(bool(torch.isfinite(out).all()), "dual bf16 not finite")
        rel = _rel_l2(out, ref)
        if outtype != "complex_mask":
            _line("dual_bf16", outtype=outtype, vs="f32 on the card",
                  rel_l2=f"{rel:.3e}", bound=BF16_REL_L2)
            _check(rel <= BF16_REL_L2, f"dual bf16 {outtype} rel L2 {rel}")
            continue
        spec = _dual_spectra(enh, wav.to(device), eps)
        _worst_bin("dual_bf16", outtype, spec, f32_spec)
        spec_l2 = [_rel_l2(a, r) for a, r in zip(spec[:2], f32_spec[:2])]
        _line("dual_bf16", outtype=outtype, vs="f32 on the card",
              speech_spec_rel_l2=f"{spec_l2[0]:.3e}",
              noise_spec_rel_l2=f"{spec_l2[1]:.3e}", bound=BF16_REL_L2,
              end_to_end_rel_l2=f"{rel:.3e}", end_to_end_held="no")
        _check(max(spec_l2) <= BF16_REL_L2,
               f"dual bf16 spectra rel L2 {spec_l2}")


# -------------------------------------------------------------- streaming


def _streamer(enc_cfg, dec_cfg, enc_state, dec_state, device: str, **kw):
    from idccrn_vae_torch.eval.streaming import StreamingEnhancer

    return StreamingEnhancer(enc_cfg, dec_cfg, enc_state, dec_state,
                             chunk_frames=STREAM_CHUNK_FRAMES, device=device,
                             **kw)


def _chunk_ms(streamer, wav: torch.Tensor, passes: int = 4) -> np.ndarray:
    """Wall time of each process_chunk, closed by a synchronize, over
    `passes` streams of wav; the first pass is warm-up and dropped."""
    m = streamer.chunk_samples
    times = []
    for p in range(passes):
        state = streamer.init_state(wav.shape[0])
        for k in range(wav.shape[1] // m):
            t0 = time.perf_counter()
            _, state = streamer.process_chunk(state, wav[:, k * m:(k + 1) * m])
            torch.cuda.synchronize()
            if p:
                times.append(1e3 * (time.perf_counter() - t0))
    return np.asarray(times)


def phase_streaming(weights, device: str, smi: str, trace_dir) -> None:
    """The nsvae streamer on the card: against the CPU, against the
    offline causal z = mu forward, its per-chunk wall time, and a
    profile of one warm chunk."""
    import torch.nn.functional as F

    cfg = _config("f32")
    card_s = _streamer(cfg, cfg, *weights, device)
    cpu_s = _streamer(cfg, cfg, *weights, "cpu")
    offline = _enhancer("f32", weights, device)
    gen = torch.Generator().manual_seed(SEED + 20)
    n = CLIP_S * FS
    chunk_ms = 1e3 * card_s.chunk_samples / FS
    for b in STREAM_BATCHES:
        wav = 0.1 * torch.randn(b, n, generator=gen)
        wav[:, :400] = 0.0  # a zero head: reflect padding == zero padding
        with _NoTf32():
            card = card_s.stream(wav)
            shifted = F.pad(wav, (STREAM_SHIFT, 0))
            zeros = torch.zeros(b, 1, shifted.shape[1] // 100 + 1, cfg.zdim)
            # zero latent noise: z = mu
            ref = offline.forward(shifted.to(device), noise=(zeros, zeros))
            torch.cuda.synchronize()
        _check_close("streaming", card, cpu_s.stream(wav), F32_REL,
                     vs="cpu", batch=b, chunk_frames=STREAM_CHUNK_FRAMES,
                     tf32="off")
        tail = card[:, STREAM_DELAY:]
        _check_close("streaming", tail, ref[:, : tail.shape[1]], F32_REL,
                     vs="offline_z_mu_on_card", batch=b, shift=STREAM_SHIFT,
                     delay=STREAM_DELAY, tf32="off")
        ms = _chunk_ms(card_s, wav.to(device))
        med = float(np.median(ms))
        _line("streaming", batch=b, chunk_ms=f"{chunk_ms:g}", chunks=len(ms),
              median_ms=f"{med:.3f}", p99_ms=f"{np.percentile(ms, 99):.3f}",
              max_ms=f"{ms.max():.3f}",
              realtime_factor=f"{chunk_ms / med:.2f}",
              audio_s_per_s=f"{b * chunk_ms / med:.1f}", card=json.dumps(smi))
        state = card_s.init_state(b)
        chunk = wav[:, : card_s.chunk_samples].to(device)
        _, state = card_s.process_chunk(state, chunk)  # warm
        _profiled("streaming_trace",
                  lambda: card_s.process_chunk(state, chunk), trace_dir,
                  f"streaming_b{b}", top=5, batch=b)


# ------------------------------------------------------------- supervised


def _supervised_config(compute: str):
    """configs/supervised_dccrn.ini with its usage line's flags: causal,
    mask reconstruction, real skips, default channels, lstm_hidden 128."""
    from idccrn_vae_torch.models.config import DccrnConfig

    return DccrnConfig(causal=True, recon_type="mask", skip_mode="real",
                       lstm_hidden=128, zdim=128, num_samples=1,
                       compute=compute)


def _datanorm(gen: torch.Generator):
    """Seeded per-bin (mean, std), each (257, 2), std > 0."""
    return (0.01 * torch.randn(257, 2, generator=gen),
            1.0 + 0.1 * torch.rand(257, 2, generator=gen))


def _loaded(cls, state, *args, **kw):
    module = cls(*args, **kw)
    module.load_state_dict(state)
    return module


def phase_supervised(device: str, smi: str, iters: int = 20):
    """Returns the model's (state_dict, datanorm) for the eval phases."""
    from idccrn_vae_torch.models.dccrn import LegacyDccrn, SupervisedDccrn

    gen = torch.Generator().manual_seed(SEED + 30)
    dn = _datanorm(gen)
    cfg = _supervised_config("f32")
    state = SupervisedDccrn(cfg, datanorm=dn, device="cpu",
                            generator=torch.Generator().manual_seed(
                                SEED + 31)).state_dict()
    model = lambda compute, dev: _loaded(
        SupervisedDccrn, state, _supervised_config(compute), datanorm=dn,
        device=dev)
    b, n = 2, CLIP_S * FS
    wav = 0.1 * torch.randn(b, n, generator=gen)
    with torch.inference_mode():
        with _NoTf32():
            card = model("f32", device)(wav.to(device))[0]
            torch.cuda.synchronize()
        _check_close("supervised", card, model("f32", "cpu")(wav)[0],
                     F32_REL, model="SupervisedDccrn", vs="cpu", tf32="off",
                     batch=b, seconds=CLIP_S)
        bf16 = model("bf16", device)(wav.to(device))[0]
        _check(bool(torch.isfinite(bf16).all()), "supervised bf16 not finite")
        rel = _rel_l2(bf16, card)
        _line("supervised", model="SupervisedDccrn", vs="f32 on the card",
              compute="bf16", rel_l2=f"{rel:.3e}", bound=BF16_REL_L2)
        _check(rel <= BF16_REL_L2, f"supervised bf16 rel L2 {rel}")

        net, bt = model("bf16", device), THROUGHPUT_BATCHES[0]
        x = 0.1 * torch.randn(bt, n, device=device,
                              generator=torch.Generator(device).manual_seed(
                                  SEED))
        torch.cuda.reset_peak_memory_stats(device)
        out = x
        for _ in range(3):  # warm-up
            out = net(x + 1e-6 * out)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = net(x + 1e-6 * out)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check(bool(torch.isfinite(out).all()), "supervised throughput output")
        peak = torch.cuda.max_memory_allocated(device)
        _line("supervised", model="SupervisedDccrn", batch=bt,
              compute="bf16", clip_s=CLIP_S, iters=iters,
              rtfx=f"{iters * bt * CLIP_S / dt:.1f}",
              ms_per_batch=f"{1e3 * dt / iters:.2f}",
              peak_mem_gib=f"{peak / 2**30:.3f}", card=json.dumps(smi))

        legacy_state = LegacyDccrn(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(
                                       SEED + 32)).state_dict()
        legacy = lambda dev: _loaded(LegacyDccrn, legacy_state, cfg,
                                     device=dev)
        with _NoTf32():
            card = legacy(device)(wav.to(device))
            torch.cuda.synchronize()
        _check_close("supervised", card, legacy("cpu")(wav), F32_REL,
                     model="LegacyDccrn", vs="cpu", tf32="off", batch=b,
                     seconds=CLIP_S)

    with _NoTf32():
        card = _streamer(cfg, cfg, state, None, device, model="supervised",
                         datanorm=dn).stream(wav)
        torch.cuda.synchronize()
    cpu = _streamer(cfg, cfg, state, None, "cpu", model="supervised",
                    datanorm=dn).stream(wav)
    _check_close("supervised", card, cpu, F32_REL, model="streamer",
                 vs="cpu", tf32="off", batch=b,
                 chunk_frames=STREAM_CHUNK_FRAMES)
    return state, dn


# -------------------------------------------------------------- vae_recon


def phase_vae_recon(device: str):
    """configs/pretrained_cvae.ini's usage line: causal, zdim 128,
    num_samples 5, --skip_padding (zero skips); with seeded datanorm.
    Returns (cfg, datanorm, encoder state, decoder state) for the eval
    phases."""
    from idccrn_vae_torch.models.config import DccrnConfig
    from idccrn_vae_torch.models.vae import VaeDecoder, VaeEncoder

    gen = torch.Generator().manual_seed(SEED + 40)
    dn = _datanorm(gen)
    cfg = DccrnConfig(causal=True, zdim=128, num_samples=5,
                      skip_mode="zero")
    seeded = lambda k: torch.Generator().manual_seed(SEED + k)
    enc_state = VaeEncoder(cfg, datanorm=dn, device="cpu",
                           generator=seeded(41)).state_dict()
    dec_state = VaeDecoder(cfg, datanorm=dn, device="cpu",
                           generator=seeded(42)).state_dict()
    b, n = 2, CLIP_S * FS
    wav = 0.1 * torch.randn(b, n, generator=gen)
    eps = tuple(torch.randn(b, cfg.num_samples, n // 100 + 1, cfg.zdim,
                            generator=gen) for _ in range(2))

    @torch.inference_mode()
    def recon(dev):
        enc = _loaded(VaeEncoder, enc_state, cfg, datanorm=dn, device=dev)
        dec = _loaded(VaeDecoder, dec_state, cfg, datanorm=dn, device=dev)
        out = enc(wav.to(dev), noise=eps)
        return dec(out.stft_x, out.z, out.skips)[0]

    with _NoTf32():
        card = recon(device)
        torch.cuda.synchronize()
    _check_close("vae_recon", card, recon("cpu"), F32_REL, vs="cpu",
                 tf32="off", batch=b, num_samples=cfg.num_samples,
                 seconds=CLIP_S)
    return cfg, dn, enc_state, dec_state


# ------------------------------------------------------------------ DNSMOS

DNSMOS_GRAPHS = ("DNSMOS/model_v8.onnx", "DNSMOS/sig.onnx",
                 "DNSMOS/bak_ovr.onnx", "DNSMOS/sig_bak_ovr.onnx",
                 "pDNSMOS/sig_bak_ovr.onnx")
DNSMOS_REL = 1e-4  # card against the numpy executor, per output
DNSMOS_GOLDENS = {"OVRL_raw": 1.612839, "SIG_raw": 1.693456,
                  "BAK_raw": 2.387266, "P808_MOS": 2.182581}
DNSMOS_WINDOW = int(9.01 * FS)


def _golden_signal() -> np.ndarray:
    """AM tone + noise, seed 42, 9.01 s (tests/test_dnsmos.py:118-123)."""
    rng = np.random.default_rng(42)
    t = np.arange(DNSMOS_WINDOW) / FS
    return (0.4 * np.sin(2 * np.pi * 300 * t)
            * (1 + 0.8 * np.sin(2 * np.pi * 2 * t))
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _dnsmos_feeds(rel: str):
    """{kind: input} of one graph: from the golden signal and from seeded
    noise. The primary models take 9.01 s of audio, model_v8 the P.808
    mel features, sig/bak_ovr a (1, 900, 161) map (the golden signal's
    log10 power spectrum over 320-sample frames, hop 160)."""
    from idccrn_vae_torch.eval.dnsmos import audio_melspec

    rng = np.random.default_rng(SEED + 60)
    noise = (0.1 * rng.standard_normal(DNSMOS_WINDOW)).astype(np.float32)
    golden = _golden_signal()
    if rel.endswith("sig_bak_ovr.onnx"):
        return {"golden": golden[None], "noise": noise[None]}
    if rel.endswith("model_v8.onnx"):
        return {k: audio_melspec(x[:-160])[None]
                for k, x in (("golden", golden), ("noise", noise))}
    idx = np.arange(900)[:, None] * 160 + np.arange(320)[None]
    frames = golden[idx] * np.hanning(320)
    logpow = np.log10(np.abs(np.fft.rfft(frames, axis=1)) ** 2 + 1e-12)
    return {"golden": logpow.astype(np.float32)[None],
            "noise": rng.standard_normal((1, 900, 161)).astype(np.float32)}


def phase_dnsmos(device: str, smi: str, iters: int = 20) -> None:
    """The five DNSMOS graphs on the card (the torch graph runner) against
    the numpy executor on the CPU, per output max |card - numpy| <=
    1e-4 * max |numpy|; the runner with TF32 left on around it (the
    session turns it off for its run and restores it) and, to show what
    that guards, the same graph run with TF32 on; every node output a
    cuda tensor; score_array's raw scores against the pinned goldens;
    warm ms per 9.01 s window, per model and for score_array."""
    from idccrn_vae_torch.eval import dnsmos
    from idccrn_vae_torch.eval.onnx_exec import InferenceSession, _run_torch

    base = os.path.join(os.path.dirname(dnsmos.__file__), os.pardir,
                        "assets", "dnsmos")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for rel in DNSMOS_GRAPHS:
            path = os.path.join(base, rel)
            card = InferenceSession(path, device=device)
            plain = InferenceSession(path, backend="numpy")
            worst = 0.0
            for kind, x in _dnsmos_feeds(rel).items():
                feed = {"input_1": x}
                env = card.run_nodes(feed)
                _check(all(isinstance(env[o], torch.Tensor) and env[o].is_cuda
                           for nd in card.nodes for o in nd.outputs),
                       f"dnsmos {rel}: a node output is off the card")
                (got,) = card.run(None, feed)
                _check(torch.backends.cudnn.allow_tf32,
                       "dnsmos: the TF32 flag was not restored")
                (want,) = plain.run(None, feed)
                _check(got.shape == want.shape and np.isfinite(got).all(),
                       f"dnsmos {rel} {kind}: {got.shape} {want.shape}")
                err = float(np.abs(got - want).max())
                scale = float(np.abs(want).max())
                worst = max(worst, err / scale)
                _check(err <= DNSMOS_REL * scale,
                       f"dnsmos {rel} {kind} rel err {err / scale}")
            with torch.inference_mode():  # TF32 left on: what the lock
                env = dict(card.inits)  # and full_f32 keep out
                env["input_1"] = torch.from_numpy(feed["input_1"]).to(device)
                tf32 = _run_torch(card.nodes, env)[card.output_names[0]]
            tf32_err = float(np.abs(tf32.cpu().numpy() - want).max()) / scale
            for _ in range(2):
                card.run(None, feed)
            t0 = time.perf_counter()
            for _ in range(iters):
                card.run(None, feed)  # returns host arrays: synchronized
            ms = 1e3 * (time.perf_counter() - t0) / iters
            nodes = sum(len(nd.outputs) for nd in card.nodes)
            _line("dnsmos", graph=rel, nodes=nodes, vs="numpy cpu",
                  max_rel_err=f"{worst:.3e}", tol=DNSMOS_REL,
                  tf32_on_rel_err=f"{tf32_err:.3e}",
                  warm_ms_per_window=f"{ms:.2f}", card=json.dumps(smi))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved

    scorer = dnsmos.ComputeScore(*dnsmos.default_model_paths(False),
                                 device=device)
    golden = _golden_signal()
    out = scorer.score_array(golden, FS)
    for k, v in DNSMOS_GOLDENS.items():
        _check(abs(out[k] - v) <= 1e-4, f"dnsmos golden {k} {out[k]} {v}")
    t0 = time.perf_counter()
    for _ in range(iters // 2):
        scorer.score_array(golden, FS)
    ms = 1e3 * (time.perf_counter() - t0) / (iters // 2)
    _line("dnsmos", score_array="golden 9.01 s", num_hops=out["num_hops"],
          **{k: f"{out[k]:.6f}" for k in DNSMOS_GOLDENS}, goldens_tol=1e-4,
          warm_ms_per_window=f"{ms:.2f}", card=json.dumps(smi))


# -------------------------------------------------------- evaluation CLIs

# --------------------------------------------------------- int8 and export

# int8 against f32 on the card, relative L2 of the clean_direct output.
# Each quantized conv rounds its input to 8 bits with one step per sample
# (abs-max / 127): on post-BN/PReLU maps whose abs-max is 4-8 times their
# RMS that is ~1-2% RMS noise per conv; the scope 'all' program has 15
# quantized convs, whose noise adds up as independent errors
# (sqrt(15) * 2% = 7.7%), on top of bf16's 0.84% (PERF.md).
INT8_REL_L2 = 0.1
INT8_SCOPES = ("enc", "all")
INT8_ITERS = 10
STAGE_ITERS = 20
# an exported program runs the eager program's aten ops: f32 against
# eager to 1e-5 of max |out| (TF32 off), bf16 to one bf16 rounding. The
# eager side runs its LSTM recurrence on the eager step loop, the aten ops
# that torch.export traces (`_traced_recurrence`); the distance to the
# eager program on the card's kernel is printed beside it
# (`vs_kernel_...`), and the kernel is held against the loop in
# `lstm_kernel`.
EXPORT_F32_REL = 1e-5
EXPORT_BF16_REL = 2.0 ** -8
EXPORT_F32_S = 0.25  # the f32 export's length: tracing time grows with it
# the bf16 export's clip: tracing costs ~11 ms of host time per graph node,
# and the node count grows with the frames of the unrolled LSTM
EXPORT_S = 0.5
STREAM_EXPORT_CHUNKS = 144
EXPORT_CLI_S = 0.5  # export_cli's bucket, windowed over the eval corpus


def _int8_enhancer(scope: str, weights, device: str):
    import dataclasses

    from idccrn_vae_torch.eval.enhance import Enhancer

    cfg = dataclasses.replace(_config("int8"), quant_scope=scope)
    return Enhancer(cfg, cfg, *weights, num_samples=1, device=device)


def _int8_stages(enh, wav, noise):
    """(output, the arguments of each quantized conv) of one int8
    forward: `ops/conv._quantized`'s (x, wr, wi, br, bi, stride,
    padding, causal, transposed)."""
    from idccrn_vae_torch.ops import conv

    calls, orig = [], conv._quantized

    def record(*args):
        calls.append(args)
        return orig(*args)

    conv._quantized = record
    try:
        out = enh.forward(wav, noise=noise)
    finally:
        conv._quantized = orig
    return out, calls


def _int8_acc(args, device: str):
    """The int8 operands and int32 accumulator of one quantized conv, on
    `device`, for the first sample of its batch (the CPU's im2col is the
    slow side)."""
    from idccrn_vae_torch.ops import conv

    x, wr, wi, _, _, stride, padding, causal, transposed = args
    move = lambda t: t.to(device)
    kernel, st, pad, dil = conv.int8_conv_geometry(
        move(wr), move(wi), stride, padding, causal, transposed)
    xq, _ = conv.quantize_input(move(x[:1]))
    kq, _ = conv.quantize_kernel(kernel)
    return xq, kq, conv.int8_conv_acc(xq, kq, st, pad, dil)


def _ms(fn, iters: int) -> float:
    """Wall ms per call of fn over `iters` warm calls, closed by a
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def phase_int8(weights, device: str, smi: str, wav, noise, ref) -> None:
    """compute='int8' at both quant scopes: each quantized stage's int32
    accumulator on the card against the CPU from the same input, the
    output against f32 on the card, RTFx beside bf16's, and each
    quantized stage's int8 path against its bf16 cuDNN conv."""
    from idccrn_vae_torch.ops import conv

    for scope in INT8_SCOPES:
        enh = _int8_enhancer(scope, weights, device)
        out, calls = _int8_stages(enh, wav.to(device), noise)
        _check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
               f"int8 {scope} output shape/finite")
        for i, args in enumerate(calls):
            with torch.inference_mode():
                card = _int8_acc(args, device)
                cpu = _int8_acc(args, "cpu")
            for name, got, want in zip(("xq", "kq", "acc"), card, cpu):
                diff = (got.cpu().long() - want.long()).abs()
                _check(not bool(diff.any()),
                       f"int8 {scope} stage {i} {name}: card and CPU differ "
                       f"at {int((diff > 0).sum())} of {diff.numel()}, "
                       f"by at most {int(diff.max())}")
        rel = _rel_l2(out, ref)
        _line("int8", scope=scope, quantized_convs=len(calls),
              acc_card_vs_cpu="bit-equal (sample 0)", batch=wav.shape[0],
              rel_l2_vs_f32=f"{rel:.3e}", bound=INT8_REL_L2)
        _check(rel <= INT8_REL_L2, f"int8 {scope} rel L2 {rel}")
    # RTFx: bf16, then each scope, in turns in this call
    phase_throughput(_enhancer("bf16", weights, device), device, smi,
                     iters=INT8_ITERS, phase="int8_throughput")
    for scope in INT8_SCOPES:
        phase_throughput(_int8_enhancer(scope, weights, device), device,
                         smi, iters=INT8_ITERS, phase="int8_throughput",
                         scope=scope)
    # per quantized stage at B=32: quantize + im2col + _int_mm +
    # dequantize against the bf16 cuDNN conv of the same shapes
    b = THROUGHPUT_BATCHES[0]
    gen = torch.Generator().manual_seed(SEED + 40)
    cfg = _config("int8")
    frames = CLIP_S * FS // cfg.stft.hop + 1
    eps = tuple(torch.randn(b, 1, frames, cfg.zdim, generator=gen)
                for _ in range(2))
    x32 = 0.1 * torch.randn(b, CLIP_S * FS, generator=gen)
    _, calls = _int8_stages(_int8_enhancer("all", weights, device),
                            x32.to(device), eps)
    tot8 = tot16 = 0.0
    with torch.inference_mode():  # the recorded maps are inference tensors
        for i, args in enumerate(calls):
            x, wr, wi, br, bi, stride, padding, causal, transposed = args
            fn16 = (conv.complex_conv_transpose2d if transposed
                    else conv.complex_conv2d)
            ms8 = _ms(lambda: conv._quantized(*args), STAGE_ITERS)
            ms16 = _ms(lambda: fn16(x, wr, wi, br, bi, stride, padding,
                                    causal=causal,
                                    compute_dtype=torch.bfloat16),
                       STAGE_ITERS)
            tot8, tot16 = tot8 + ms8, tot16 + ms16
            _line("int8_stage", index=i,
                  kind="tconv" if transposed else "conv",
                  input="x".join(map(str, x.shape)),
                  weight="x".join(map(str, wr.shape)), int8_ms=f"{ms8:.3f}",
                  bf16_ms=f"{ms16:.3f}", int8_over_bf16=f"{ms8 / ms16:.2f}")
    _line("int8_stage", stages=len(calls), batch=b, int8_ms=f"{tot8:.3f}",
          bf16_ms=f"{tot16:.3f}", card=json.dumps(smi))


def _artifact_check(phase: str, got, want, rel: float, **fields) -> None:
    err, scale = _max_rel(got, want)
    _line(phase, **fields, bit_equal=bool(torch.equal(got, want)),
          max_abs_err=f"{err:.3e}", max_abs_out=f"{scale:.3e}", tol=rel)
    _check(tuple(got.shape) == tuple(want.shape), f"{phase} shape")
    _check(err <= rel * scale, f"{phase} rel err {err / scale}")


@contextlib.contextmanager
def _traced_recurrence():
    """The eager program with its LSTM recurrence on the eager step loop,
    as torch.export traces it: an artifact is held to the program it
    holds. On the card with no grad `ops/lstm.py` `_layer` takes the
    kernel, whose float32 sums run in another order than cuBLAS's, so
    at bf16 an h near a rounding boundary can round the other way and
    the later steps carry it on."""
    from idccrn_vae_torch.ops import lstm

    kernel = lstm._layer_cuda
    lstm._layer_cuda = lstm._layer_plain
    try:
        yield
    finally:
        lstm._layer_cuda = kernel


def _chained_rtfx(fn, b: int, device: str, iters: int,
                  seconds: float = CLIP_S) -> float:
    n = int(seconds * FS)
    gen = torch.Generator().manual_seed(SEED + 61)
    wav = (0.1 * torch.randn(b, n, generator=gen)).to(device)
    out = fn(wav)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(wav + 1e-6 * out)
    torch.cuda.synchronize()
    return iters * b * seconds / (time.perf_counter() - t0)


def phase_export(weights, device: str, smi: str) -> None:
    """torch.export of clean_direct at 0.5 s (bf16) on the card, timed; the
    artifact against the eager program with the same draws at B=1 and
    32; RTFx of both; an f32 export against eager with TF32 off; the
    streaming artifact against StreamingEnhancer over 144 chunks."""
    from idccrn_vae_torch.eval import export

    n = int(EXPORT_S * FS)
    enh = _enhancer("bf16", weights, device)
    serving = export.serving_fn_nsvae(enh)
    t0 = time.perf_counter()
    prog = export.export_serving(serving, n, device)
    export_s = time.perf_counter() - t0
    module = prog.module()
    _line("export", program="clean_direct", compute="bf16", clip_s=EXPORT_S,
          export_s=f"{export_s:.1f}", graph_nodes=len(prog.graph.nodes))
    gen = torch.Generator().manual_seed(SEED + 60)
    for b in (1, THROUGHPUT_BATCHES[0]):
        wav = (0.1 * torch.randn(b, n, generator=gen)).to(device)
        eps = serving.draw_eps(b, n, gen, device)
        with torch.no_grad():
            got = module(wav, *eps)
        with _traced_recurrence():
            want = enh.forward(wav, noise=(eps[0], eps[1]))
        kernel_err, _ = _max_rel(got, enh.forward(wav, noise=(eps[0],
                                                               eps[1])))
        _artifact_check("export", got, want, EXPORT_BF16_REL, batch=b,
                        vs="eager bf16, same eps, the traced recurrence",
                        vs_kernel_max_abs_err=f"{kernel_err:.3e}")
    b = THROUGHPUT_BATCHES[0]

    def artifact(w):
        with torch.no_grad():
            return module(w, *serving.draw_eps(b, n, gen, device))

    def eager(w):
        return enh.forward(w, noise=tuple(serving.draw_eps(b, n, gen,
                                                            device)[:2]))

    rtfx = [(name, _chained_rtfx(fn, b, device, INT8_ITERS, EXPORT_S))
            for name, fn in (("eager", eager), ("artifact", artifact),
                             ("artifact", artifact), ("eager", eager))]
    _line("export", batch=b, clip_s=EXPORT_S, iters=INT8_ITERS,
          rtfx=",".join(f"{k}:{v:.1f}" for k, v in rtfx),
          order="eager,artifact,artifact,eager", card=json.dumps(smi))

    m = int(EXPORT_F32_S * FS)
    enh32 = _enhancer("f32", weights, device)
    s32 = export.serving_fn_nsvae(enh32)
    with _NoTf32():
        t0 = time.perf_counter()
        prog32 = export.export_serving(s32, m, device)
        f32_s = time.perf_counter() - t0
        wav = (0.1 * torch.randn(2, m, generator=gen)).to(device)
        eps = s32.draw_eps(2, m, gen, device)
        with torch.no_grad():
            got = prog32.module()(wav, *eps)
        with _traced_recurrence():
            want = enh32.forward(wav, noise=(eps[0], eps[1]))
        kernel_err, _ = _max_rel(got, enh32.forward(wav, noise=(eps[0],
                                                                 eps[1])))
    _artifact_check("export", got, want, EXPORT_F32_REL, batch=2,
                    compute="f32", clip_s=EXPORT_F32_S,
                    export_s=f"{f32_s:.1f}", tf32="off",
                    vs="eager, the traced recurrence",
                    vs_kernel_max_abs_err=f"{kernel_err:.3e}")

    cfg = _config("f32")
    streamer = _streamer(cfg, cfg, *weights, device)
    t0 = time.perf_counter()
    sprog, spec = export.export_streaming(streamer, batch=1)
    stream_s = time.perf_counter() - t0
    step = sprog.module()
    mchunk = streamer.chunk_samples
    wav = 0.1 * torch.randn(1, STREAM_EXPORT_CHUNKS * mchunk, generator=gen)
    state = [torch.zeros(shape, device=device) for shape, _ in spec]
    ref_state = streamer.init_state(1)
    kernel_state = streamer.init_state(1)
    outs, refs, kernel_refs = [], [], []
    with _NoTf32(), torch.no_grad():
        for k in range(STREAM_EXPORT_CHUNKS):
            chunk = wav[:, k * mchunk:(k + 1) * mchunk].to(device)
            out, state = step(state, chunk)
            with _traced_recurrence():
                ref, ref_state = streamer.process_chunk(ref_state, chunk)
            kref, kernel_state = streamer.process_chunk(kernel_state, chunk)
            outs.append(out)
            refs.append(ref)
            kernel_refs.append(kref)
    kernel_err, _ = _max_rel(torch.cat(outs, 1), torch.cat(kernel_refs, 1))
    _artifact_check("export_stream", torch.cat(outs, 1), torch.cat(refs, 1),
                    EXPORT_F32_REL, batch=1, chunks=STREAM_EXPORT_CHUNKS,
                    chunk_frames=STREAM_CHUNK_FRAMES,
                    export_s=f"{stream_s:.1f}", state_tensors=len(spec),
                    tf32="off", vs="eager, the traced recurrence",
                    vs_kernel_max_abs_err=f"{kernel_err:.3e}")


EVAL_UTTS = 24
EVAL_MAX_S = 6.0
EVAL_MIN_S = 1.5
STREAM_FILES = 4


class _Timed:
    """Wall time of named callables while a CLI runs: for the block,
    each (owner, attribute) is wrapped to append (attribute, seconds)
    to `calls` per call, and restored after."""

    def __init__(self, *targets):
        self.targets = targets
        self.calls = []

    def __enter__(self):
        self.saved = [(owner, name, getattr(owner, name))
                      for owner, name in self.targets]
        for owner, name, fn in self.saved:
            setattr(owner, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)  # each wrapped call returns host data
            self.calls.append((name, time.perf_counter() - t0))
            return out
        return timed

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    def seconds(self, name):
        return [dt for n, dt in self.calls if n == name]


def _pcm16(x: np.ndarray) -> np.ndarray:
    """What write_wav stores for float32 x, read back as read_wav does."""
    x = np.asarray(x, np.float32)
    return (np.round(np.clip(x, -1.0, 1.0) * 32767.0) / 32768.0).astype(
        np.float32)


def _check_wavs(phase: str, out_dir: str, names, want) -> float:
    """Each written wav is the PCM16 form of `want` to one step; returns
    the largest difference in PCM16 steps."""
    worst = _wav_diff(out_dir, names, want, phase)
    _check(worst <= 1.0, f"{phase} wavs differ by {worst} PCM16 steps")
    return worst


def _wav_diff(out_dir: str, names, want, phase: str = "wavs") -> float:
    """The largest difference in PCM16 steps between the written wavs and
    the PCM16 form of `want`."""
    from idccrn_vae_torch.data.audio_io import read_wav

    worst = 0.0
    for name, w in zip(names, want):
        got, fs = read_wav(os.path.join(out_dir, name))
        _check(fs == FS and got.shape == w.shape,
               f"{phase} {name}: {got.shape} at {fs} Hz, want {w.shape}")
        worst = max(worst, float(np.abs(got - _pcm16(w)).max()) * 32768)
    return worst


def _make_corpus(root: str):
    """24 validation utterances of `data/synth.make_corpus` (6 s mixes,
    the four SNR buckets round-robin), each then cut to a seeded length
    in [1.5, 6] s so the batches fall in several buckets (the labels
    stay those of the 6 s mixes). Returns (noisy dir, clean dir,
    corpus_meta.json path, noisy paths)."""
    from idccrn_vae_torch.data.audio_io import read_wav, write_wav
    from idccrn_vae_torch.data.segments import find_wavs
    from idccrn_vae_torch.data.synth import make_corpus

    dirs, _ = make_corpus(root, 0, EVAL_UTTS, utt_seconds=EVAL_MAX_S,
                          seed=SEED)
    lengths = np.random.default_rng(SEED + 50).integers(
        int(EVAL_MIN_S * FS), int(EVAL_MAX_S * FS) + 1, size=EVAL_UTTS)
    for i, n in enumerate(lengths):
        for kind in ("noisy", "clean"):
            path = os.path.join(dirs[f"{kind}_val"], f"{kind}_fileid_{i}.wav")
            write_wav(path, read_wav(path)[0][:n], FS)
    return (dirs["noisy_val"], dirs["clean_val"],
            os.path.join(root, "corpus_meta.json"),
            find_wavs(dirs["noisy_val"]))


def _write_checkpoints(root: str, weights, supervised, vae) -> dict:
    """The script's seeded weights as port checkpoint dirs (meta.json in
    the JAX package's schema, best.pt): phase 1's NSVAE dir and its
    pretrained-CVAE decoder dir (the f32/bf16 phases' weights), the
    pretrained VAE of phase vae_recon and the supervised DCCRN of phase
    supervised, each with its datanorm."""
    from idccrn_vae_torch.train.checkpoint import (
        CheckpointManager,
        datanorm_to_meta,
    )

    cfg = _config("f32")
    vae_cfg, vae_dn, vae_enc, vae_dec = vae
    sup_state, sup_dn = supervised
    dirs = {}
    for name, meta, best in (
            ("cvae", {"config": cfg, "datanorm": None}, {"dec": weights[1]}),
            ("nsvae", {"pre_config": cfg, "noisy_config": cfg},
             {"noisy_enc": weights[0]}),
            ("vae", {"config": vae_cfg, "datanorm": datanorm_to_meta(vae_dn)},
             {"enc": vae_enc, "dec": vae_dec}),
            ("supervised", {"config": _supervised_config("f32"),
                            "datanorm": datanorm_to_meta(sup_dn)},
             sup_state)):
        dirs[name] = os.path.join(root, name)
        ckpt = CheckpointManager(dirs[name])
        ckpt.save_meta(meta)
        ckpt.save_best(best)
    return dirs


def _finite_scores(phase: str, res: dict, n: int) -> None:
    per = res["per_utterance"]
    _check(len(per) == n, f"{phase} scored {len(per)} of {n} utterances")
    _check(all(np.isfinite(list(v.values())).all() for v in per.values()),
           f"{phase}: a score is not finite")


def _means(res: dict) -> str:
    return ",".join(f"{k}:{v['mean']:.3f}" for k, v in res["summary"].items())


def _device_args(device):
    """The CLIs run on their default device, the card, unless a
    rehearsal without one names another."""
    return [] if device is None else ["--device", device]


def phase_eval_cli(dirs: dict, corpus, out_root: str, smi: str,
                   device=None) -> None:
    """cli/test_enhance (phase 1, --compute bf16, the CLI's defaults:
    num_samples 10, batch 8) over the corpus, with --write_wavs and
    --corpus_meta. The same Enhancer's enhance_utterances with the same
    seed runs first on the card: it warms the shapes up and is what the
    written wavs are held against. The CLI's wall time is split by
    wrapping the runner's load_testset / score_pairs and
    Enhancer.enhance_utterances, each of which returns host data."""
    import dataclasses

    from idccrn_vae_torch.cli import test_enhance
    from idccrn_vae_torch.cli.common import load_enhancement_checkpoints
    from idccrn_vae_torch.eval import runners
    from idccrn_vae_torch.eval.enhance import Enhancer

    noisy_dir, clean_dir, meta_path, paths = corpus
    enc_cfg, dec_cfg, enc, dec, _, pad_mode = load_enhancement_checkpoints(
        dirs["nsvae"], dirs["cvae"])
    bf16 = lambda c: dataclasses.replace(c, compute="bf16")
    enh = Enhancer(bf16(enc_cfg), bf16(dec_cfg), enc, dec, num_samples=10,
                   pad_mode=pad_mode, device=device)
    wavs = runners.load_testset(paths)
    want = enh.enhance_utterances(wavs, batch_size=8,
                                  generator=enh.new_generator(0))
    out = os.path.join(out_root, "eval_cli")
    with _Timed((runners, "load_testset"), (runners, "score_pairs"),
                (Enhancer, "enhance_utterances")) as t:
        t0 = time.perf_counter()
        res = test_enhance.main([
            "--nsvae_dir", dirs["nsvae"], "--decoder_dir", dirs["cvae"],
            "--noisy_dir", noisy_dir, "--clean_dir", clean_dir,
            "--out_dir", out, "--compute", "bf16", "--write_wavs",
            "--corpus_meta", meta_path, *_device_args(device)])
        cli_s = time.perf_counter() - t0
    _finite_scores("eval_cli", res, len(paths))
    _finite_scores("eval_cli noisy", {"per_utterance":
                                      res["noisy_per_utterance"]}, len(paths))
    _check(len(res["per_snr_bucket"]) == 4, "eval_cli bucket report")
    names = [os.path.basename(p) for p in paths]
    lsb = _check_wavs("eval_cli", os.path.join(out, "enhanced"), names, want)
    load_s = sum(t.seconds("load_testset"))
    (enhance_s,) = t.seconds("enhance_utterances")
    score_enh, score_noisy = t.seconds("score_pairs")
    audio_s = sum(len(w) for w in wavs) / FS
    n = len(paths)
    _line("eval_cli", utterances=n, audio_s=f"{audio_s:.2f}",
          compute="bf16", num_samples=10, batch=8,
          buckets=len(res["per_snr_bucket"]), wav_max_diff_pcm16=f"{lsb:g}",
          warm="reference run first", card=json.dumps(smi))
    _line("eval_cli", cli_s=f"{cli_s:.3f}", load_s=f"{load_s:.3f}",
          enhance_s=f"{enhance_s:.3f}",
          score_enhanced_s=f"{score_enh:.3f}",
          score_noisy_s=f"{score_noisy:.3f}",
          other_s=f"{cli_s - load_s - enhance_s - score_enh - score_noisy:.3f}",
          host_share=f"{1 - enhance_s / cli_s:.3f}",
          enhance_rtfx=f"{audio_s / enhance_s:.1f}",
          cli_rtfx=f"{audio_s / cli_s:.1f}",
          score_ms_per_utt=f"{1e3 * (score_enh + score_noisy) / (2 * n):.1f}")
    _line("eval_cli", random_weights="scores say nothing of quality",
          enhanced_means=_means(res),
          noisy_means=_means({"summary": res["noisy_summary"]}))


DNSMOS_KEYS = ("OVRL_raw", "SIG_raw", "BAK_raw", "OVRL", "SIG", "BAK",
               "P808_MOS")


def phase_dnsmos_cli(out_root: str, smi: str, device=None) -> None:
    """cli/dnsmos on the card over the wavs eval_cli wrote, with a CSV;
    each row against the CPU executor's (the torch runner on the CPU)
    score of the same file, every score to 1e-4 relative; wall per
    file."""
    import csv

    from idccrn_vae_torch.cli import dnsmos as dnsmos_cli
    from idccrn_vae_torch.eval.dnsmos import ComputeScore, default_model_paths

    wav_dir = os.path.join(out_root, "eval_cli", "enhanced")
    csv_path = os.path.join(out_root, "dnsmos.csv")
    t0 = time.perf_counter()
    dnsmos_cli.main(["-t", wav_dir, "-o", csv_path, *_device_args(device)])
    cli_s = time.perf_counter() - t0
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    n = len(os.listdir(wav_dir))
    _check(len(rows) == n, f"dnsmos_cli scored {len(rows)} of {n} files")
    cpu = ComputeScore(*default_model_paths(False), device="cpu")
    worst, hops = 0.0, 0
    for row in rows:
        want = cpu(row["filename"])
        hops += want["num_hops"]
        _check(int(row["num_hops"]) == want["num_hops"],
               f"dnsmos_cli hops of {row['filename']}")
        for k in DNSMOS_KEYS:
            got = float(row[k])
            _check(np.isfinite(got), f"dnsmos_cli {k} is not finite")
            rel = abs(got - want[k]) / abs(want[k])
            worst = max(worst, rel)
            _check(rel <= DNSMOS_REL, f"dnsmos_cli {k} rel err {rel}")
    _line("dnsmos_cli", files=n, windows=hops, vs="torch cpu",
          max_rel_err=f"{worst:.3e}", tol=DNSMOS_REL, cli_s=f"{cli_s:.3f}",
          ms_per_file=f"{1e3 * cli_s / n:.1f}",
          ms_per_window=f"{1e3 * cli_s / hops:.2f}", card=json.dumps(smi))


def phase_prevae_cli(dirs: dict, corpus, out_root: str, smi: str,
                     device=None) -> None:
    """cli/test_prevae (num_samples 10, batch 8) over the corpus's clean
    split, after one warm-up batch of the longest utterances through the
    same encoder and decoder."""
    from idccrn_vae_torch.cli import test_prevae
    from idccrn_vae_torch.cli.common import config_from_meta
    from idccrn_vae_torch.data.segments import find_wavs
    from idccrn_vae_torch.eval.enhance import bucket_pad_length
    from idccrn_vae_torch.models.vae import VaeDecoder, VaeEncoder
    from idccrn_vae_torch.train.checkpoint import (
        CheckpointManager,
        datanorm_from_meta,
    )

    ckpt = CheckpointManager(dirs["vae"])
    meta, best = ckpt.load_meta(), ckpt.load_best()
    cfg, dn = config_from_meta(meta), datanorm_from_meta(meta)
    enc = _loaded(VaeEncoder, best["enc"], cfg, dn, device=device)
    dec = _loaded(VaeDecoder, best["dec"], cfg, dn, device=device)
    warm = torch.zeros(8, bucket_pad_length(int(EVAL_MAX_S * FS), 100),
                       device=next(enc.parameters()).device)
    with torch.inference_mode():
        z = enc(warm, num_samples=10)
        dec(z.stft_x, z.z, z.skips, num_samples=10)[0].cpu()
    clean_dir = corpus[1]
    out = os.path.join(out_root, "prevae_cli")
    t0 = time.perf_counter()
    res = test_prevae.main(["--model_dir", dirs["vae"], "--test_dir",
                            clean_dir, "--out_dir", out,
                            "--num_samples", "10", *_device_args(device)])
    cli_s = time.perf_counter() - t0
    n = len(find_wavs(clean_dir))
    _finite_scores("prevae_cli", res, n)
    diag = res["latent_diag"]
    keys = {"var_real", "var_imag", "offdiag_mean_abs_real",
            "offdiag_mean_abs_imag"}
    _check(set(diag) == keys, f"prevae_cli latent_diag keys {sorted(diag)}")
    _check(all(np.isfinite(np.asarray(diag[k], np.float64)).all()
               and np.size(diag[k]) in (1, cfg.zdim) for k in keys),
           "prevae_cli latent_diag values")
    audio_s = _audio_seconds(clean_dir)
    _line("prevae_cli", utterances=n, audio_s=f"{audio_s:.2f}",
          num_samples=10, batch=8, compute=cfg.compute,
          cli_s=f"{cli_s:.3f}", cli_rtfx=f"{audio_s / cli_s:.1f}",
          latent_diag=",".join(sorted(diag)),
          cov_figure=os.path.exists(os.path.join(out, "cov_mu_diag.png")),
          warm="one batch", card=json.dumps(smi))
    _line("prevae_cli", random_weights="scores say nothing of quality",
          means=_means(res))


def _audio_seconds(wav_dir: str) -> float:
    from idccrn_vae_torch.data.audio_io import read_wav
    from idccrn_vae_torch.data.segments import find_wavs

    return sum(len(read_wav(p)[0]) for p in find_wavs(wav_dir)) / FS


def phase_supervised_cli(dirs: dict, corpus, out_root: str, smi: str,
                         device=None) -> None:
    """cli/test_supervised (batch 8, --write_wavs, --corpus_meta). The
    model is deterministic: each written wav is held against
    SupervisedDccrn on the card over the runner's batches (sorted by
    length, 8 at a time, each padded to its bucket), which run first
    and warm the shapes up."""
    from idccrn_vae_torch.cli import test_supervised
    from idccrn_vae_torch.cli.common import config_from_meta
    from idccrn_vae_torch.eval.enhance import bucket_pad_length
    from idccrn_vae_torch.eval.runners import load_testset
    from idccrn_vae_torch.models.dccrn import SupervisedDccrn
    from idccrn_vae_torch.train.checkpoint import (
        CheckpointManager,
        datanorm_from_meta,
    )

    noisy_dir, clean_dir, meta_path, paths = corpus
    ckpt = CheckpointManager(dirs["supervised"])
    cfg = config_from_meta(ckpt.load_meta())
    model = _loaded(SupervisedDccrn, ckpt.load_best(), cfg,
                    datanorm_from_meta(ckpt.load_meta()), device=device)
    on = next(model.parameters()).device
    wavs = load_testset(paths)
    want = [None] * len(wavs)
    order = np.argsort([len(w) for w in wavs])
    for i in range(0, len(order), 8):
        chunk = order[i : i + 8]
        batch = np.zeros((len(chunk), bucket_pad_length(
            max(len(wavs[j]) for j in chunk), cfg.stft.hop)), np.float32)
        for r, j in enumerate(chunk):
            batch[r, : len(wavs[j])] = wavs[j]
        with torch.inference_mode():
            out = model(torch.from_numpy(batch).to(on))[0].cpu().numpy()
        for r, j in enumerate(chunk):
            want[j] = out[r, : len(wavs[j])]
    out_dir = os.path.join(out_root, "supervised_cli")
    t0 = time.perf_counter()
    res = test_supervised.main([
        "--model_dir", dirs["supervised"], "--noisy_dir", noisy_dir,
        "--clean_dir", clean_dir, "--out_dir", out_dir, "--write_wavs",
        "--corpus_meta", meta_path, *_device_args(device)])
    cli_s = time.perf_counter() - t0
    _finite_scores("supervised_cli", res, len(paths))
    names = [os.path.basename(p) for p in paths]
    lsb = _check_wavs("supervised_cli", os.path.join(out_dir, "enhanced"),
                      names, want)
    audio_s = sum(len(w) for w in wavs) / FS
    _line("supervised_cli", utterances=len(paths), audio_s=f"{audio_s:.2f}",
          batch=8, compute=cfg.compute, cli_s=f"{cli_s:.3f}",
          cli_rtfx=f"{audio_s / cli_s:.1f}",
          wav_max_diff_pcm16=f"{lsb:g}",
          buckets=len(res["per_snr_bucket"]),
          warm="reference run first", card=json.dumps(smi))
    _line("supervised_cli", random_weights="scores say nothing of quality",
          means=_means(res))


def phase_stream_cli(dirs: dict, corpus, out_root: str, smi: str,
                     device=None) -> None:
    """cli/stream_enhance (phase-1 NSVAE, 10-frame chunks) over 4 of the
    corpus's noisy files; each output wav is held against
    StreamingEnhancer.stream of the same file on the card, which runs
    first. The CLI's report line is printed as one field here."""
    import contextlib
    import io
    import shutil

    from idccrn_vae_torch.cli import stream_enhance
    from idccrn_vae_torch.cli.common import load_enhancement_checkpoints
    from idccrn_vae_torch.data.audio_io import read_wav
    from idccrn_vae_torch.eval.streaming import StreamingEnhancer

    in_dir = os.path.join(out_root, "stream_in")
    os.makedirs(in_dir)
    paths = corpus[3][:STREAM_FILES]
    for p in paths:
        shutil.copy(p, in_dir)
    enc_cfg, dec_cfg, enc, dec, _, _ = load_enhancement_checkpoints(
        dirs["nsvae"], dirs["cvae"])
    streamer = StreamingEnhancer(enc_cfg, dec_cfg, enc, dec,
                                 chunk_frames=STREAM_CHUNK_FRAMES,
                                 device=device)
    want = [streamer.stream(read_wav(p)[0][None]).cpu().numpy()[0]
            for p in paths]
    out = os.path.join(out_root, "stream_cli")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        report = stream_enhance.main([
            "--nsvae_dir", dirs["nsvae"], "--decoder_dir", dirs["cvae"],
            "--in_dir", in_dir, "--out_dir", out,
            "--chunk_frames", str(STREAM_CHUNK_FRAMES),
            *_device_args(device)])
    cli_s = time.perf_counter() - t0
    _check(json.loads(printed.getvalue()) == report,
           "stream_cli printed report")
    _check(report["files"] == len(paths), "stream_cli file count")
    lsb = _check_wavs("stream_cli", out,
                      [os.path.basename(p) for p in paths], want)
    _line("stream_cli", files=len(paths), cli_s=f"{cli_s:.3f}",
          wav_max_diff_pcm16=f"{lsb:g}", warm="reference stream first",
          card=json.dumps(smi))
    _line("stream_cli", report=json.dumps(report, separators=(",", ":")))


def phase_export_cli(dirs: dict, corpus, out_root: str, smi: str,
                     device=None) -> None:
    """cli/export_model (phase-1 NSVAE, clean_direct, one 1 s bucket)
    then cli/run_artifact over the corpus; each wav against the same
    windowing (`run_artifact.windowed_enhance`) of the eager Enhancer
    with the same draws (a generator seeded 0, as the CLI's --seed 0)."""
    import contextlib
    import io

    from idccrn_vae_torch.cli import export_model, run_artifact
    from idccrn_vae_torch.cli.common import load_enhancement_checkpoints
    from idccrn_vae_torch.device import resolve_device
    from idccrn_vae_torch.eval import export, runners
    from idccrn_vae_torch.eval.enhance import Enhancer

    noisy_dir, _, _, paths = corpus
    art = os.path.join(out_root, "artifact")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        export_model.main(["--nsvae_dir", dirs["nsvae"], "--decoder_dir",
                           dirs["cvae"], "--out_dir", art, "--seconds",
                           str(EXPORT_CLI_S), *_device_args(device)])
    export_s = time.perf_counter() - t0
    meta = json.loads(printed.getvalue())
    out = os.path.join(out_root, "artifact_out")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        report = run_artifact.main([
            "--artifact_dir", art, "--in_dir", noisy_dir, "--out_dir", out,
            "--batch_size", "32", "--seed", "0", *_device_args(device)])
    run_s = time.perf_counter() - t0
    enc_cfg, dec_cfg, enc, dec, _, pad_mode = load_enhancement_checkpoints(
        dirs["nsvae"], dirs["cvae"])
    live = Enhancer(enc_cfg, dec_cfg, enc, dec, num_samples=1,
                    pad_mode=pad_mode, device=device)
    serving = export.serving_fn_nsvae(live)
    eager = export.bucketed_call([(meta["length"], serving.call)], serving,
                                 resolve_device(device))
    names = [os.path.basename(p) for p in paths]

    def windowed():
        gen = torch.Generator().manual_seed(0)
        return run_artifact.windowed_enhance(
            lambda b: eager(b, generator=gen).cpu().numpy(),
            runners.load_testset(paths), meta["length"], meta["n_fft"], 32)

    with _traced_recurrence():
        want, windows = windowed()
    _check(windows == report["windows"], "export_cli window count")
    lsb = _check_wavs("export_cli", out, names, want)
    kernel_want, _ = windowed()
    kernel_lsb = _wav_diff(out, names, kernel_want)
    _line("export_cli", files=report["files"], windows=windows,
          bucket_s=EXPORT_CLI_S, export_model_s=f"{export_s:.1f}",
          run_artifact_s=f"{run_s:.1f}",
          artifact_rtfx=report["rtf_x"], wav_max_diff_pcm16=f"{lsb:g}",
          vs="eager, same windows and draws, the traced recurrence",
          vs_kernel_wav_max_diff_pcm16=f"{kernel_lsb:g}",
          card=json.dumps(smi))


def phase_eval_cli_int8(dirs: dict, corpus, out_root: str, smi: str,
                        device=None) -> None:
    """cli/test_enhance --compute int8 (phase 1, the CLI's defaults:
    num_samples 10, batch 8, quant_scope 'enc'): finite scores, CLI RTFx."""
    from idccrn_vae_torch.cli import test_enhance

    noisy_dir, clean_dir, meta_path, paths = corpus
    t0 = time.perf_counter()
    res = test_enhance.main([
        "--nsvae_dir", dirs["nsvae"], "--decoder_dir", dirs["cvae"],
        "--noisy_dir", noisy_dir, "--clean_dir", clean_dir,
        "--out_dir", os.path.join(out_root, "eval_cli_int8"),
        "--compute", "int8", "--corpus_meta", meta_path,
        *_device_args(device)])
    cli_s = time.perf_counter() - t0
    _finite_scores("eval_cli_int8", res, len(paths))
    audio_s = _audio_seconds(noisy_dir)
    _line("eval_cli_int8", utterances=len(paths), compute="int8",
          num_samples=10, batch=8, cli_s=f"{cli_s:.3f}",
          cli_rtfx=f"{audio_s / cli_s:.1f}", enhanced_means=_means(res),
          card=json.dumps(smi))


# --------------------------------------------------------------- training

REPO = os.path.dirname(os.path.abspath(__file__))
TRAIN_SEGMENT = 480 * 100  # a 481-frame segment: (sequence_len - 1) * hop
PRETRAIN_BATCH = 16  # configs/pretrained_cvae.ini [DataFrame] batch_size
NSVAE_BATCH = 24  # configs/nsvae_config.ini [DataFrame] batch_size
CHECK_BATCH = 2
TRAIN_ITERS = 4
# One f32 train step on the card against the same step on the CPU (TF32
# off, same weights, batch and latent draws): the loss within
# TRAIN_LOSS_REL relative; each parameter's gradient within
# TRAIN_GRAD_REL_L2 of its L2 norm. The forward is well conditioned (its
# loss agrees to ~1e-7), the backward is not: each train-mode BN's
# backward subtracts the batch means of the incoming gradient, so
# summation-order roundings grow stage by stage towards the encoder. The
# card is not bitwise reproducible either (cuDNN and reductions pick
# their own orders): two card runs of the same step differ by up to ~3e-3
# in a scalar parameter's gradient, and the phase prints that spread
# beside the card-vs-CPU error. A gradient whose norm is below 1e-6 of
# the whole model's is zero up to rounding (a conv bias ahead of a
# train-mode BN, which subtracts the per-channel batch mean): it is held
# in absolute terms, to 1e-6 of the model's gradient norm. The training
# phases of phase 2 and of the supervised DCCRN hold a PReLU slope to
# PRELU_GRAD_REL_L2 instead: the slope is one scalar summed over a whole
# activation map, with heavy cancellation where the map is mostly
# positive, and its card-vs-CPU error reaches 2.2e-2 there (PERF.md,
# section 6); a missing or sign-flipped slope gradient reads 1 or more.
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL_L2 = 1e-2
PRELU_GRAD_REL_L2 = 5e-2
CVAE_FLAGS = ["--causal", "--zdim", "128", "--num_samples", "5",
              "--skip_padding", "--kl_weight", "0.01",
              "--recon_loss_weight", "1.0,1.0,0.0", "--first_use_dataset"]
NSVAE_FLAGS = ["--causal", "--zdim", "128", "--latent_num", "2",
               "--nsvae_model", "original", "--alpha", "1.0", "--w_kl",
               "1.0", "--w_dismiu", "0.0", "--first_use_dataset"]
TRAIN_UTTS = (16, 12)  # train, val utterances of 6.5 s: 2 segments each
TRAIN_EPOCHS = 2


def _pretrain_config(compute: str, remat: bool = False):
    """configs/pretrained_cvae.ini's usage line: causal, zdim 128,
    num_samples 5, --skip_padding (zero skips)."""
    from idccrn_vae_torch.models.config import DccrnConfig

    return DccrnConfig(causal=True, zdim=128, num_samples=5,
                       skip_mode="zero", compute=compute, remat=remat)


def _pretrain_trainer(compute: str, device: str, mi_weight: float = 0.0,
                      remat: bool = False):
    """The CVAE trainer of the usage line (kl_weight 0.01, no warm-up,
    recon weights 1,1,0, lr 3e-4); its weights come from seeded CPU
    generators, so every call builds the same model."""
    from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
    from idccrn_vae_torch.train.pretrain import PretrainTrainer

    loss = PretrainVaeLoss(np.full(0, 0.01, np.float32), 0.01,
                           mi_weight=mi_weight,
                           recon_loss_weight=(1.0, 1.0, 0.0), num_samples=5)
    return PretrainTrainer(_pretrain_config(compute, remat), loss, 3e-4,
                           seed=SEED + 60, device=device)


def _nsvae_trainer(compute: str, device: str):
    """configs/nsvae_config.ini's usage line: latent_num 2, original
    channels, alpha 1, w_kl 1, w_dismiu 0, frozen pretrained encoders of
    the CVAE geometry (whose zero skips turn the residual term off)."""
    from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
    from idccrn_vae_torch.train.nsvae import NsvaeTrainer

    noisy = _noisy_config(compute)
    loss = NsvaeTrueKlLoss(1.0, 0.0, 1.0, 0.0, noisy, use_skips=False)
    return NsvaeTrainer(_pretrain_config(compute), noisy, loss, 1e-3,
                        seed=SEED + 70, device=device)


def _noisy_config(compute: str):
    """The NSVAE's noisy encoder of configs/nsvae_config.ini's usage line:
    latent_num 2, original channels."""
    from idccrn_vae_torch.models.config import DccrnConfig

    return DccrnConfig(causal=True, zdim=128, latent_num=2, num_samples=1,
                       skip_mode="none",
                       skip_to_use=_pretrain_config(compute).skip_to_use,
                       compute=compute)


def _grads(module) -> dict:
    return {k: p.grad.detach().float().cpu()
            for k, p in module.named_parameters() if p.grad is not None}


def _check_grads(phase: str, card: dict, cpu: dict, card2: dict,
                 prelu_tol: float = TRAIN_GRAD_REL_L2, spread_of=None,
                 **fields) -> None:
    """Card gradients against the CPU's, per parameter and over the whole
    model; `card2` is a second card run of the same step as `spread_of`
    (default: `card`), whose spread is printed beside the card-vs-CPU
    error. A PReLU slope is held to `prelu_tol`, every other gradient to
    TRAIN_GRAD_REL_L2."""
    spread_of = card if spread_of is None else spread_of
    _check(sorted(card) == sorted(cpu) == sorted(card2) and len(cpu) > 0,
           f"{phase}: gradients of different parameters")
    total = sum(float(g.norm()) ** 2 for g in cpu.values()) ** 0.5
    worst = {False: (0.0, ""), True: (0.0, "")}  # keyed by "is a slope"
    spread, spread_name, zero, over = 0.0, "", 0, []
    for k, ref in cpu.items():
        _check(bool(torch.isfinite(card[k]).all()),
               f"{phase}: gradient of {k} is not finite")
        if float(ref.norm()) <= 1e-6 * total:  # zero up to rounding
            zero += 1
            _check(float((card[k] - ref).norm()) <= 1e-6 * total,
                   f"{phase}: gradient of {k}")
            continue
        gap = float((card2[k] - spread_of[k]).norm() / ref.norm())
        if gap > spread:
            spread, spread_name = gap, k
        slope = k.endswith("prelu.weight")
        err = _rel_l2(card[k], ref)
        if err > worst[slope][0]:
            worst[slope] = (err, k)
        bound = prelu_tol if slope else TRAIN_GRAD_REL_L2
        if err > bound:
            over.append(f"{k} rel L2 {err:.3e} > {bound:.3e}")
    cat = lambda g: torch.cat([g[k].flatten() for k in sorted(cpu)])
    _line(phase, **fields, params=len(cpu), zero_up_to_rounding=zero,
          grad_norm=f"{total:.3e}",
          model_rel_l2=f"{_rel_l2(cat(card), cat(cpu)):.3e}",
          worst_grad_rel_l2=f"{worst[False][0]:.3e}",
          worst_param=worst[False][1], tol=TRAIN_GRAD_REL_L2,
          worst_prelu_rel_l2=f"{worst[True][0]:.3e}",
          worst_prelu=worst[True][1], prelu_tol=prelu_tol,
          card_vs_card_worst=f"{spread:.3e}", card_vs_card_param=spread_name)
    _check(not over, f"{phase}: gradient of {'; '.join(over)}")


def _check_loss(phase: str, card: dict, cpu: dict, key: str = "total",
                **fields) -> None:
    got, want = float(card[key]), float(cpu[key])
    _check(all(np.isfinite(float(v)) for v in card.values()),
           f"{phase}: a loss is not finite")
    rel = abs(got - want) / abs(want)
    _line(phase, **fields, loss=key, loss_card=f"{got:.6e}",
          loss_cpu=f"{want:.6e}", rel_err=f"{rel:.3e}", tol=TRAIN_LOSS_REL)
    _check(rel <= TRAIN_LOSS_REL, f"{phase}: {key} rel err {rel}")


def _time_steps(phase: str, trainer, batch, device: str, smi: str,
                **fields) -> None:
    """TRAIN_ITERS warm train steps (Adam) on one on-device batch, closed
    by a synchronize: ms per step, segments per second, peak memory."""
    gen = torch.Generator(device).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):  # warm-up: cuDNN plans, allocator, Adam state
        trainer.train_step(batch, gen, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_ITERS):
        metrics = trainer.train_step(batch, gen, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _check(bool(torch.isfinite(metrics["total"])), f"{phase} loss")
    b = (batch[0] if isinstance(batch, tuple) else batch).shape[0]
    peak = torch.cuda.max_memory_allocated(device)
    _line(phase, **fields, batch=b, iters=TRAIN_ITERS,
          ms_per_step=f"{1e3 * dt / TRAIN_ITERS:.2f}",
          segments_per_s=f"{TRAIN_ITERS * b / dt:.2f}",
          peak_mem_gib=f"{peak / 2**30:.3f}", card=json.dumps(smi))


def _segments(gen: torch.Generator, b: int, k: int = 1):
    """k seeded (b, 3 s) batches on the CPU."""
    out = tuple(0.1 * torch.randn(b, TRAIN_SEGMENT, generator=gen)
                for _ in range(k))
    return out[0] if k == 1 else out


def phase_pretrain_step(device: str, smi: str):
    """One f32 CVAE step at B=2 on the card against the CPU (loss and
    every gradient), then warm Adam steps at the ini's B=16, f32 and
    bf16. Returns the f32 trainer and its B=16 batch for train_trace."""
    gen = torch.Generator().manual_seed(SEED + 61)
    wav = _segments(gen, CHECK_BATCH)
    cfg = _pretrain_config("f32")
    frames = TRAIN_SEGMENT // cfg.stft.hop + 1
    eps = tuple(torch.randn(CHECK_BATCH, cfg.num_samples, frames, cfg.zdim,
                            generator=gen) for _ in range(2))
    def step(dev):
        trainer = _pretrain_trainer("f32", dev)
        metrics = trainer.train_step(wav, None, 0, noise=tuple(
            e.to(dev) for e in eps))
        return metrics, {n: _grads(getattr(trainer, n))
                         for n in ("encoder", "decoder")}

    t0 = time.perf_counter()
    with _NoTf32():
        (m_card, card), (_, card2) = step(device), step(device)
    m_cpu, cpu = step("cpu")
    fields = dict(vs="cpu", tf32="off", batch=CHECK_BATCH, num_samples=5,
                  seconds=TRAIN_SEGMENT // FS,
                  check_s=f"{time.perf_counter() - t0:.1f}")
    _check_loss("pretrain_step", m_card, m_cpu, **fields)
    for name in ("encoder", "decoder"):
        _check_grads("pretrain_step", card[name], cpu[name], card2[name],
                     model=name, **fields)
    batch = _segments(gen, PRETRAIN_BATCH).to(device)
    trainers = {}
    for compute in ("f32", "bf16"):
        trainers[compute] = _pretrain_trainer(compute, device)
        _time_steps("pretrain_step", trainers[compute], batch, device, smi,
                    compute=compute, num_samples=5, optimizer="adam")
    return trainers["f32"], batch


def phase_nsvae_step(device: str, smi: str) -> None:
    """One f32 NSVAE step at B=2 on the card against the CPU (loss and
    every gradient of the noisy encoder; the frozen encoders' weights
    and statistics unchanged), then warm Adam steps at the ini's B=24,
    f32 and bf16. The loss reads only posteriors: no latent noise
    enters it."""
    gen = torch.Generator().manual_seed(SEED + 71)
    batch = _segments(gen, CHECK_BATCH, 3)  # noisy, clean, noise
    def step(dev):
        trainer = _nsvae_trainer("f32", dev)
        frozen = [{k: v.clone() for k, v in
                   trainer.models[n].state_dict().items()}
                  for n in ("clean_enc", "noise_enc")]
        metrics = trainer.train_step(batch, None, 0)
        for n, before in zip(("clean_enc", "noise_enc"), frozen):
            _check(all(torch.equal(v, before[k]) for k, v in
                       trainer.models[n].state_dict().items()),
                   f"nsvae_step: the frozen {n} changed")
        return metrics, _grads(trainer.models["noisy_enc"])

    t0 = time.perf_counter()
    with _NoTf32():
        (m_card, card), (_, card2) = step(device), step(device)
    m_cpu, cpu = step("cpu")
    fields = dict(vs="cpu", tf32="off", batch=CHECK_BATCH,
                  seconds=TRAIN_SEGMENT // FS,
                  check_s=f"{time.perf_counter() - t0:.1f}")
    _check_loss("nsvae_step", m_card, m_cpu, **fields)
    _check_grads("nsvae_step", card, cpu, card2, model="noisy_enc",
                 **fields)
    big = tuple(x.to(device) for x in _segments(gen, NSVAE_BATCH, 3))
    for compute in ("f32", "bf16"):
        _time_steps("nsvae_step", _nsvae_trainer(compute, device), big,
                    device, smi, compute=compute, latent_num=2,
                    optimizer="adam")


def _trace_step(phase: str, trainer, batch, trace_dir, stem: str,
                what: str) -> None:
    """torch.profiler over one warm train step: the top device kernels,
    device ops per step, busy share, and the device time by the aten op
    that launched it."""
    from torch.autograd import DeviceType

    first = batch[0] if isinstance(batch, tuple) else batch
    gen = torch.Generator(first.device).manual_seed(SEED)
    trainer.train_step(batch, gen, 0)  # warm
    torch.cuda.synchronize()
    averages = _profiled(phase, lambda: trainer.train_step(batch, gen, 0),
                         trace_dir, stem, top=8, batch=first.shape[0],
                         compute="f32", what=what)
    ops = [e for e in averages
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
           and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ops)
    _line(phase, by="aten op", device_ms=f"{busy / 1e3:.2f}")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:110]}", flush=True)


def phase_train_trace(trainer, batch, trace_dir) -> None:
    """One warm f32 CVAE step at B=16 under torch.profiler."""
    _trace_step("train_trace", trainer, batch, trace_dir, "train_b16_f32",
                "one CVAE train step")


def _train_ini(name: str, path: str, user: dict, epochs: int) -> str:
    """configs/<name> with its [User] paths pointed at `user` and
    `epochs` epochs, saving every epoch."""
    from idccrn_vae_torch.utils.config import load_ini

    ini = load_ini(os.path.join(REPO, "configs", name))
    for k, v in user.items():
        ini.set("User", k, v)
    ini.set("Training", "epochs", str(epochs))
    ini.set("Training", "save_frequency", "1")
    with open(path, "w") as f:
        ini.write(f)
    return path


def _timed_cli(main, argv):
    t0 = time.perf_counter()
    out = main(argv)
    return out, time.perf_counter() - t0


def _check_run(phase: str, curves, best, run_dir, epochs: int,
               last_epoch: int) -> None:
    from idccrn_vae_torch.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(run_dir)
    meta = ckpt.load_meta()
    _check(len(curves["train"]) == len(curves["val"]) == epochs,
           f"{phase}: {len(curves['train'])} epochs run, want {epochs}")
    _check(all(np.isfinite(v) for split in ("train", "val")
               for row in curves[split] for v in row.values())
           and np.isfinite(best), f"{phase}: a loss is not finite")
    _check(meta["epoch"] == last_epoch and ckpt.has_best(),
           f"{phase}: meta epoch {meta['epoch']}, want {last_epoch}")


def phase_train_cli(root: str, smi: str):
    """The training CLIs on the card, on a synth corpus of 16 train and
    12 val utterances of 6.5 s (two 481-frame segments each), with the
    configs' inis pointed at it: train_vae on clean speech and on noise,
    train_nsvae against both (2 epochs each), train_nsvae resumed for a
    third epoch, then test_enhance --phase 1 on the NSVAE and CVAE
    runs. Returns the corpus dirs and the run dirs."""
    from idccrn_vae_torch.cli import test_enhance, train_nsvae, train_vae
    from idccrn_vae_torch.data.synth import make_corpus

    t0 = time.perf_counter()
    dirs, _ = make_corpus(os.path.join(root, "corpus"), *TRAIN_UTTS,
                          utt_seconds=6.5, seed=SEED + 80)
    corpus_s = time.perf_counter() - t0
    runs, walls = {}, {}
    for kind, cfg in (("clean", "pretrained_cvae.ini"),
                      ("noise", "pretrained_nvae.ini")):
        ini = _train_ini(cfg, os.path.join(root, f"{kind}.ini"), {
            "saved_root": os.path.join(root, f"{kind}_runs"),
            "train_data_dir": dirs[f"{kind}_train"],
            "val_data_dir": dirs[f"{kind}_val"]}, TRAIN_EPOCHS)
        (curves, best, runs[kind]), walls[kind] = _timed_cli(
            train_vae.main, ["--cfg_file", ini, *CVAE_FLAGS])
        _check_run(f"train_cli {kind}", curves, best, runs[kind],
                   TRAIN_EPOCHS, TRAIN_EPOCHS - 1)
    user = {f"{k}_{s}_data_dir": dirs[f"{k}_{s}"]
            for k in ("noisy", "clean", "noise") for s in ("train", "val")}
    user.update(saved_root=os.path.join(root, "nsvae_runs"),
                pre_clean_encoder=runs["clean"],
                pre_noise_encoder=runs["noise"])
    ini = _train_ini("nsvae_config.ini", os.path.join(root, "nsvae.ini"),
                     user, TRAIN_EPOCHS)
    (curves, best, runs["nsvae"]), walls["nsvae"] = _timed_cli(
        train_nsvae.main, ["--cfg_file", ini, *NSVAE_FLAGS])
    _check_run("train_cli nsvae", curves, best, runs["nsvae"], TRAIN_EPOCHS,
               TRAIN_EPOCHS - 1)
    ini = _train_ini("nsvae_config.ini", os.path.join(root, "nsvae3.ini"),
                     user, TRAIN_EPOCHS + 1)
    (curves, best, resumed), walls["resume"] = _timed_cli(
        train_nsvae.main, ["--cfg_file", ini, *NSVAE_FLAGS[:-1], "--reload",
                           "--reload_savedir", runs["nsvae"]])
    _check(resumed == runs["nsvae"], "train_cli resume dir")
    _check_run("train_cli resume", curves, best, resumed, 1, TRAIN_EPOCHS)
    res, walls["test_enhance"] = _timed_cli(test_enhance.main, [
        "--nsvae_dir", runs["nsvae"], "--decoder_dir", runs["clean"],
        "--noisy_dir", dirs["noisy_val"], "--clean_dir", dirs["clean_val"],
        "--out_dir", os.path.join(root, "enhanced")])
    _finite_scores("train_cli test_enhance", res, TRAIN_UTTS[1])
    _line("train_cli", corpus=f"{TRAIN_UTTS[0]}+{TRAIN_UTTS[1]}x6.5s",
          corpus_s=f"{corpus_s:.2f}", epochs=TRAIN_EPOCHS,
          **{f"{k}_s": f"{v:.2f}" for k, v in walls.items()},
          card=json.dumps(smi))
    _line("train_cli", random_init="scores say nothing of quality",
          means=_means(res))
    return dirs, runs


# ----------------------------------------------------- training, part 2

PHASE2_BATCH = 16  # configs/two_phase_training.ini [DataFrame] batch_size
SUPERVISED_BATCH = 16  # configs/supervised_dccrn.ini [DataFrame] batch_size
PHASE2_FLAGS = ["--causal", "--zdim", "128", "--use_sc_phase2",
                "--recon_type", "mask", "--num_samples", "1",
                "--first_use_dataset"]
SUPERVISED_FLAGS = ["--causal", "--recon_type", "mask",
                    "--recon_loss_weight", "1.0,1.0,0.0", "--data_norm",
                    "--first_use_dataset"]


def _phase2_trainer(compute: str, device: str, adversarial: bool,
                    encoder=None):
    """configs/two_phase_training.ini's usage line (--use_sc_phase2
    --recon_type mask --num_samples 1, lr 1e-4) on the NSVAE of
    nsvae_step: classical with both decoders (--latent_num 2), or
    --adversarial --d_step 1 (the clean decoder and D). `encoder`: the
    noisy encoder's state_dict."""
    import dataclasses

    from idccrn_vae_torch.losses.phase2 import TwoPhaseLoss
    from idccrn_vae_torch.train.phase2 import Phase2Trainer

    latent_num = 1 if adversarial else 2
    dec = dataclasses.replace(_pretrain_config(compute), skip_mode="runtime",
                              recon_type="mask", num_samples=1,
                              latent_num=latent_num)
    trainer = Phase2Trainer(
        _noisy_config(compute), dec,
        TwoPhaseLoss((1.0, 1.0, 0.0), alpha=1.0, latent_num=latent_num),
        1e-4, adversarial=adversarial, dis_lr=1e-4, d_step=1,
        seed=SEED + 90, device=device)
    if encoder is not None:
        trainer.load_pretrained({"encoder": encoder})
    return trainer


def phase_phase2_step(device: str, smi: str, encoder, adversarial: bool):
    """One f32 phase-2 step at B=2 on the card against the CPU, TF32 off,
    same weights, batch and latent draws: the losses (the generator's
    total, and for the adversarial run D's loss) and the gradients of the
    decoder(s) and of D; the frozen encoder unchanged. Then warm Adam
    steps at the ini's B=16, f32 and (classical) bf16. Returns the f32
    trainer and its B=16 batch."""
    phase = "adv_step" if adversarial else "phase2_step"
    gen = torch.Generator().manual_seed(SEED + (93 if adversarial else 91))
    batch = _segments(gen, CHECK_BATCH, 3)  # noisy, clean, noise
    cfg = _noisy_config("f32")
    frames = TRAIN_SEGMENT // cfg.stft.hop + 1
    eps = [tuple(torch.randn(CHECK_BATCH, 1, frames, cfg.zdim, generator=gen)
                 for _ in range(2)) for _ in range(2)]  # speech, noise

    def step(dev):
        trainer = _phase2_trainer("f32", dev, adversarial, encoder)
        before = {k: v.clone() for k, v in
                  trainer.encoder.state_dict().items()}
        metrics = trainer.train_step(batch, None, 0, *[
            tuple(e.to(dev) for e in pair) for pair in eps])
        _check(all(torch.equal(v, before[k]) for k, v in
                   trainer.encoder.state_dict().items()),
               f"{phase}: the frozen encoder changed")
        return metrics, {n: _grads(m) for n, m in trainer.models.items()
                         if n != "encoder"}

    t0 = time.perf_counter()
    with _NoTf32():
        (m_card, card), (_, card2) = step(device), step(device)
    m_cpu, cpu = step("cpu")
    fields = dict(vs="cpu", tf32="off", batch=CHECK_BATCH,
                  seconds=TRAIN_SEGMENT // FS,
                  check_s=f"{time.perf_counter() - t0:.1f}")
    for key in ("total", "dis") if adversarial else ("total",):
        _check_loss(phase, m_card, m_cpu, key=key, **fields)
    for name in cpu:
        _check_grads(phase, card[name], cpu[name], card2[name],
                     prelu_tol=PRELU_GRAD_REL_L2, model=name, **fields)
    big = tuple(x.to(device) for x in _segments(gen, PHASE2_BATCH, 3))
    trainers = {}
    # the adversarial step is host-bound at ~96k device ops: bf16 moves
    # nothing there, and its time goes to the script's budget instead
    for compute in ("f32",) if adversarial else ("f32", "bf16"):
        trainers[compute] = _phase2_trainer(compute, device, adversarial,
                                            encoder)
        _time_steps(phase, trainers[compute], big, device, smi,
                    compute=compute, models="+".join(cpu), optimizer="adam")
    return trainers["f32"], big


def phase_adv_trace(trainer, batch, trace_dir) -> None:
    """One warm f32 adversarial phase-2 step at B=16 under
    torch.profiler."""
    _trace_step("adv_trace", trainer, batch, trace_dir, "adv_b16_f32",
                "one adversarial phase-2 step (D update, then G)")


def _supervised_trainer(compute: str, device: str, datanorm):
    """configs/supervised_dccrn.ini's usage line (causal, mask, real skips,
    recon weights 1,1,0, lr 1e-3) with --data_norm."""
    from idccrn_vae_torch.losses.phase2 import EteTrainSeLoss
    from idccrn_vae_torch.train.supervised import SupervisedTrainer

    return SupervisedTrainer(_supervised_config(compute),
                             EteTrainSeLoss((1.0, 1.0, 0.0)), 1e-3,
                             datanorm=datanorm, seed=SEED + 100,
                             device=device)


def phase_supervised_step(device: str, smi: str) -> None:
    """One f32 supervised step at B=2 on the card against the CPU (loss
    and every gradient), then warm Adam steps at the ini's B=16, f32 and
    bf16. The model draws no noise."""
    gen = torch.Generator().manual_seed(SEED + 101)
    dn = tuple(t.numpy() for t in _datanorm(gen))
    batch = _segments(gen, CHECK_BATCH, 2)  # noisy, clean

    def step(dev):
        trainer = _supervised_trainer("f32", dev, dn)
        return trainer.train_step(batch, None, 0), _grads(trainer.model)

    t0 = time.perf_counter()
    with _NoTf32():
        (m_card, card), (_, card2) = step(device), step(device)
    m_cpu, cpu = step("cpu")
    fields = dict(vs="cpu", tf32="off", batch=CHECK_BATCH, datanorm="on",
                  seconds=TRAIN_SEGMENT // FS,
                  check_s=f"{time.perf_counter() - t0:.1f}")
    _check_loss("supervised_step", m_card, m_cpu, **fields)
    _check_grads("supervised_step", card, cpu, card2,
                 prelu_tol=PRELU_GRAD_REL_L2, model="model", **fields)
    big = tuple(x.to(device) for x in _segments(gen, SUPERVISED_BATCH, 2))
    for compute in ("f32", "bf16"):
        _time_steps("supervised_step", _supervised_trainer(compute, device,
                                                           dn),
                    big, device, smi, compute=compute, optimizer="adam")


def phase_train2_cli(root: str, smi: str, dirs: dict, runs: dict) -> None:
    """The rest of the recipe's CLIs on the card, on train_cli's corpus
    and runs: cal_mean_std over the noisy train split, train_supervised
    --data_norm with its files, train_phase2 classical (--latent_num 2
    --load_de from the CVAE run) and --adversarial (2 epochs each), the
    adversarial run resumed for a third epoch, then test_enhance --phase
    2 on the classical run and test_supervised on the supervised run."""
    from idccrn_vae_torch.cli import (
        cal_mean_std,
        test_enhance,
        test_supervised,
        train_phase2,
        train_supervised,
    )

    walls = {}
    stats = [os.path.join(root, f"{k}_noisy.txt") for k in ("mean", "std")]
    (mean, std), walls["cal_mean_std"] = _timed_cli(cal_mean_std.main, [
        "--data_dir", dirs["noisy_train"], "--mean_out", stats[0],
        "--std_out", stats[1]])
    _check(mean.shape == std.shape == (257, 2)
           and bool(np.isfinite(mean).all() and np.isfinite(std).all())
           and float(std.min()) >= 0.0 and float(std.max()) > 0.0,
           "train2_cli: cal_mean_std statistics")
    triplet = {f"{k}_{s}_data_dir": dirs[f"{k}_{s}"]
               for k in ("noisy", "clean", "noise") for s in ("train", "val")}
    ini = _train_ini("supervised_dccrn.ini", os.path.join(root, "sup.ini"),
                     dict(triplet, saved_root=os.path.join(root, "sup_runs"),
                          mean_file=stats[0], std_file=stats[1]),
                     TRAIN_EPOCHS)
    (curves, best, sup_run), walls["supervised"] = _timed_cli(
        train_supervised.main, ["--cfg_file", ini, *SUPERVISED_FLAGS])
    _check_run("train2_cli supervised", curves, best, sup_run, TRAIN_EPOCHS,
               TRAIN_EPOCHS - 1)
    phase2_runs = {}
    adversarial = ["--adversarial", "--dlr", "1e-4", "--d_step", "1"]
    for kind, flags in (
            ("classical", ["--latent_num", "2", "--load_de",
                           "--pre_decoder_dir", runs["clean"]]),
            ("adversarial", adversarial)):
        ini = _train_ini("two_phase_training.ini",
                         os.path.join(root, f"{kind}.ini"),
                         dict(triplet,
                              saved_root=os.path.join(root, f"{kind}_runs")),
                         TRAIN_EPOCHS)
        (curves, best, phase2_runs[kind]), walls[kind] = _timed_cli(
            train_phase2.main, ["--cfg_file", ini, "--first_phase_folder",
                                runs["nsvae"], *PHASE2_FLAGS, *flags])
        _check_run(f"train2_cli {kind}", curves, best, phase2_runs[kind],
                   TRAIN_EPOCHS, TRAIN_EPOCHS - 1)
    ini = _train_ini("two_phase_training.ini",
                     os.path.join(root, "adversarial3.ini"),
                     dict(triplet, saved_root=os.path.join(root, "unused")),
                     TRAIN_EPOCHS + 1)
    (curves, best, resumed), walls["resume"] = _timed_cli(train_phase2.main, [
        "--cfg_file", ini, "--first_phase_folder", runs["nsvae"],
        *PHASE2_FLAGS[:-1], *adversarial, "--reload", "--reload_savedir",
        phase2_runs["adversarial"]])
    _check(resumed == phase2_runs["adversarial"], "train2_cli resume dir")
    _check_run("train2_cli resume", curves, best, resumed, 1, TRAIN_EPOCHS)
    res, walls["test_enhance"] = _timed_cli(test_enhance.main, [
        "--nsvae_dir", phase2_runs["classical"], "--phase", "2",
        "--noisy_dir", dirs["noisy_val"], "--clean_dir", dirs["clean_val"],
        "--out_dir", os.path.join(root, "enhanced2")])
    _finite_scores("train2_cli test_enhance", res, TRAIN_UTTS[1])
    res_sup, walls["test_supervised"] = _timed_cli(test_supervised.main, [
        "--model_dir", sup_run, "--noisy_dir", dirs["noisy_val"],
        "--clean_dir", dirs["clean_val"], "--out_dir",
        os.path.join(root, "supervised_eval")])
    _finite_scores("train2_cli test_supervised", res_sup, TRAIN_UTTS[1])
    _line("train2_cli", epochs=TRAIN_EPOCHS,
          **{f"{k}_s": f"{v:.2f}" for k, v in walls.items()},
          card=json.dumps(smi))
    _line("train2_cli", random_init="scores say nothing of quality",
          phase2=_means(res), supervised=_means(res_sup))


# ------------------------------------------ data parallelism and remat

DDP_WORLD = 2
DDP_ITERS = 1
DDP_MI_WEIGHT = 0.2
# world 2 against world 1 on the card, TF32 off: the standing card
# bounds (TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2, PRELU_GRAD_REL_L2); each
# model's BN running statistics, concatenated, to DDP_STAT_REL relative
# L2 (they are the first step's batch statistics: sums in another order)
DDP_STAT_REL = 1e-4
DDP_TIMEOUT_S = 300
DDP_KINDS = ("pretrain", "nsvae", "adversarial", "supervised")
# ddp_cli's curves against the plain run's: test_torch_port_convert.py's
# trajectory bound (Adam's normalisation amplifies f32 differences of
# near-zero gradients over the epochs)
DDP_CURVE_REL = 1e-3


def _ddp_case(kind: str, device: str):
    """(trainer, global batch on the CPU) of one trainer at its ini's
    batch and the reference width, seeded: pretraining with the MI term
    (B=16, S=5), the NSVAE (B=24), adversarial phase 2 (B=16, d_step 1)
    and the supervised DCCRN with datanorm (B=16)."""
    gen = torch.Generator().manual_seed(SEED + 110)
    if kind == "pretrain":
        return (_pretrain_trainer("f32", device, DDP_MI_WEIGHT),
                _segments(gen, PRETRAIN_BATCH))
    if kind == "nsvae":
        return _nsvae_trainer("f32", device), _segments(gen, NSVAE_BATCH, 3)
    if kind == "adversarial":
        return (_phase2_trainer("f32", device, adversarial=True),
                _segments(gen, PHASE2_BATCH, 3))
    dn = tuple(t.numpy() for t in _datanorm(gen))
    return (_supervised_trainer("f32", device, dn),
            _segments(gen, SUPERVISED_BATCH, 2))


def _ddp_steps(device: str) -> dict:
    """One f32 step of each trainer, in this process or as a rank of a
    data-parallel group: kind -> (metrics averaged over the ranks,
    gradients of the trained models, every model's BN buffers, ms per
    step over DDP_ITERS further steps). TF32 is off for all of it, the
    timed steps too, so both worlds time the same arithmetic. The step's
    generator is seeded alike on every rank, which draws the global
    batch's noise."""
    with _NoTf32():
        return _ddp_steps_f32(device)


def _ddp_steps_f32(device: str) -> dict:
    from idccrn_vae_torch.parallel import distributed

    out = {}
    for kind in DDP_KINDS:
        trainer, batch = _ddp_case(kind, device)
        gen = torch.Generator(device).manual_seed(SEED + 111)
        metrics = trainer.train_step(batch, gen, 0)
        keys = sorted(metrics)
        sums = distributed.all_reduce_floats(
            [float(metrics[k]) for k in keys], device)
        metrics = {k: v / distributed.world() for k, v in zip(keys, sums)}
        grads = {n: g for n, m in trainer.models.items() if (g := _grads(m))}
        stats = {n: _buffers(m) for n, m in trainer.models.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DDP_ITERS):
            trainer.train_step(batch, gen, 0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / DDP_ITERS
        out[kind] = (metrics, grads, stats, ms)
        del trainer
        torch.cuda.empty_cache()
    return out


def _buffers(module) -> dict:
    """A copy of a module's BN running statistics and counters."""
    return {k: b.detach().to("cpu", copy=True)
            for k, b in module.named_buffers() if not k.startswith("dn_")}


def _check_stats(phase: str, got: dict, want: dict, **fields) -> None:
    """Each model's BN counters equal, its running statistics to
    DDP_STAT_REL relative L2 (concatenated)."""
    for name in want:
        counts = {k for k in want[name] if k.endswith("count")}
        _check(all(torch.equal(got[name][k], want[name][k]) for k in counts),
               f"{phase}: {name} BN counters differ")
        keys = sorted(set(want[name]) - counts)
        if not keys:
            continue
        cat = lambda d: torch.cat([d[k].float().flatten() for k in keys])
        rel = _rel_l2(cat(got[name]), cat(want[name]))
        _line(phase, **fields, model=name, bn_buffers=len(keys),
              counters=sorted({int(want[name][k]) for k in counts}),
              stats_rel_l2=f"{rel:.3e}", tol=DDP_STAT_REL)
        _check(rel <= DDP_STAT_REL, f"{phase}: {name} BN statistics {rel}")


def phase_ddp(device: str, smi: str) -> None:
    """Data parallelism on the card: world 2 on Gloo with CUDA tensors,
    both ranks on this card (NCCL refuses two ranks on one device),
    spawned here; one step of each trainer at its ini's batch against the
    same step in one process, twice (the card's own spread): the losses,
    every gradient, the BN statistics and counters; ms per step of both.
    The world-2 time carries Gloo's staging through host memory and two
    processes sharing one card: it is not a scaling figure."""
    import datetime

    from idccrn_vae_torch.parallel import distributed

    t0 = time.perf_counter()
    one, one2 = _ddp_steps(device), _ddp_steps(device)
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    two = distributed.spawn(
        _ddp_steps, DDP_WORLD, args=(f"{device}:0",), backend="gloo",
        device=f"{device}:0",
        timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S),
        deadline=DDP_TIMEOUT_S)
    two_s = time.perf_counter() - t0
    _line("ddp", world=DDP_WORLD, backend="gloo", tensors="cuda:0",
          why="NCCL refuses two ranks on one device",
          world1_s=f"{one_s:.1f}", world2_s=f"{two_s:.1f}",
          card=json.dumps(smi))
    for kind in DDP_KINDS:
        (m1, g1, s1, ms1), (_, g1b, _, _) = one[kind], one2[kind]
        m2, g2, s2, ms2 = two[kind]
        fields = dict(trainer=kind, vs="world 1", tf32="off")
        for key in ("total", "dis") if kind == "adversarial" else ("total",):
            _check_loss("ddp", m2, m1, key=key, **fields)
        for name in g1:
            _check_grads("ddp", g2[name], g1[name], g1b[name],
                         prelu_tol=PRELU_GRAD_REL_L2, spread_of=g1[name],
                         model=name, **fields)
        _check_stats("ddp", s2, s1, **fields)
        _line("ddp", trainer=kind, ms_per_step_world1=f"{ms1:.2f}",
              ms_per_step_world2=f"{ms2:.2f}", iters=DDP_ITERS,
              scaling="none: two ranks share one card, Gloo stages "
                      "every collective through host memory")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_ddp_cli(root: str, smi: str, dirs: dict, runs: dict) -> None:
    """train_vae on train_cli's corpus and ini, 2 epochs, under a one-rank
    NCCL group joined from the environment torchrun sets: its
    loss_curves.json against train_cli's plain run of the same ini,
    flags and seed (to DDP_CURVE_REL: the runs differ in the order of the
    BN sums, which Adam carries over the epochs), rank 0's run dir; then
    train_vae without a group and with --n_devices 2 on this one-card
    host, which resolves to world 1 (JAX's auto_mesh rule)."""
    from idccrn_vae_torch.cli import train_vae
    from idccrn_vae_torch.parallel import distributed
    from idccrn_vae_torch.parallel.mesh import auto_world

    user = {"train_data_dir": dirs["clean_train"],
            "val_data_dir": dirs["clean_val"]}
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    ini = _train_ini("pretrained_cvae.ini", os.path.join(root, "ddp.ini"),
                     dict(user, saved_root=os.path.join(root, "ddp_runs")),
                     TRAIN_EPOCHS)
    os.environ.update(env)
    try:
        (curves, best, run), wall = _timed_cli(
            train_vae.main, ["--cfg_file", ini, *CVAE_FLAGS])
    finally:
        for k in env:
            del os.environ[k]
    _check(not distributed.active(), "ddp_cli: the CLI left its group")
    _check_run("ddp_cli nccl", curves, best, run, TRAIN_EPOCHS,
               TRAIN_EPOCHS - 1)
    with open(os.path.join(run, "train.log")) as f:
        log = f.read()
    _check(log.count("data-parallel world 1") == 1, "ddp_cli: train.log")
    with open(os.path.join(runs["clean"], "loss_curves.json")) as f:
        plain = json.load(f)
    worst, where = 0.0, ""
    for split in ("train", "val"):
        for epoch, (got, want) in enumerate(zip(curves[split],
                                                plain[split])):
            _check(set(got) == set(want), "ddp_cli: metric keys")
            for k in want:
                rel = abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                if rel > worst:
                    worst, where = rel, f"{split}[{epoch}].{k}"
    _line("ddp_cli", backend="nccl", world=1, env="torchrun",
          wall_s=f"{wall:.2f}", vs="train_cli plain run",
          worst_curve_rel=f"{worst:.3e}", worst_at=where, tol=DDP_CURVE_REL,
          card=json.dumps(smi))
    _check(worst <= DDP_CURVE_REL, f"ddp_cli: {where} rel {worst}")
    ini = _train_ini("pretrained_cvae.ini", os.path.join(root, "ddp2.ini"),
                     dict(user, saved_root=os.path.join(root, "ddp2_runs")),
                     1)
    (curves, best, run), wall = _timed_cli(
        train_vae.main, ["--cfg_file", ini, *CVAE_FLAGS, "--n_devices", "2"])
    _check_run("ddp_cli n_devices 2", curves, best, run, 1, 0)
    with open(os.path.join(run, "train.log")) as f:
        resolved = "data-parallel world 1" in f.read()
    world = auto_world(PRETRAIN_BATCH, 2, "cuda")
    _line("ddp_cli", n_devices=2, cards=torch.cuda.device_count(),
          auto_world=world, train_log_world1=resolved,
          wall_s=f"{wall:.2f}", epochs=1)
    _check(world == 1 and resolved, "ddp_cli: --n_devices 2 on one card")


def phase_remat(device: str, smi: str) -> None:
    """cfg.remat on the card: a CVAE step at B=16, f32 (TF32 off), with
    remat on against off (twice, the card's spread): the loss, every
    gradient, the BN statistics, and every counter at 1 (the running
    update happened once); then warm Adam steps of each, with their peak
    memory."""
    gen = torch.Generator().manual_seed(SEED + 120)
    batch = _segments(gen, PRETRAIN_BATCH).to(device)

    def step(remat):
        trainer = _pretrain_trainer("f32", device, remat=remat)
        g = torch.Generator(device).manual_seed(SEED + 121)
        with _NoTf32():
            metrics = trainer.train_step(batch, g, 0)
        return (metrics, {n: _grads(m) for n, m in trainer.models.items()},
                {n: _buffers(m) for n, m in trainer.models.items()})

    (m_on, g_on, s_on), (m_off, g_off, s_off), (_, g_off2, _) = (
        step(True), step(False), step(False))
    fields = dict(vs="remat off", batch=PRETRAIN_BATCH, tf32="off")
    _check_loss("remat", m_on, m_off, **fields)
    for name in g_off:
        _check_grads("remat", g_on[name], g_off[name], g_off2[name],
                     spread_of=g_off[name], model=name, **fields)
    _check_stats("remat", s_on, s_off, **fields)
    _check(all(int(v) == 1 for d in s_on.values() for k, v in d.items()
               if k.endswith("count")), "remat: a BN counter is not 1")
    torch.cuda.empty_cache()
    for remat in (False, True):
        _time_steps("remat", _pretrain_trainer("f32", device, remat=remat),
                    batch, device, smi, remat=remat, optimizer="adam")
        torch.cuda.empty_cache()


# ------------------------------------------------------ measurement tools

# the tools' shortened counts here; their defaults are the JAX tools'
# fullwidth_bf16_step: each trainer's step at the reference geometry at
# bf16 against the same step at f32 (TF32 off), from the same weights and
# latent draws, the recipes of the CPU parity tool
# (port_tools/fullwidth_parity.py, which builds them with
# tests/torch_port_util.py's pair helpers), from the port's own seeded
# init. At the tool's batch and segment each loss component's and each
# trained model's whole-gradient distance of bf16 from f32 on the card is
# held to the tool's yardstick against the same step of the port on this
# host's CPU (same weights and draws): YARD_RATIO times the CPU's
# distance plus YARD_FLOOR; the JAX package's distances recorded by the
# tool (FULLWIDTH_PARITY_TORCH.json, from JAX's init) are printed beside.
# At the ini's batch of 3 s segments the card's distances are printed.
FULLWIDTH_JSON = "FULLWIDTH_PARITY_TORCH.json"
FULLWIDTH_CASES = {"pretrain_zero": 16, "pretrain_real": 16, "nsvae": 24,
                   "phase2": 16, "phase2_adv": 16, "supervised": 16}
FULLWIDTH_LR = 1e-2


def _fullwidth_base(compute: str):
    """DccrnConfig()'s widths and STFT, num_samples 1."""
    from idccrn_vae_torch.models.config import DccrnConfig

    return DccrnConfig(num_samples=1, compute=compute)


def _fullwidth_trainer(case: str, compute: str, device: str):
    """The port side of torch_port_util's pair helper for `case`, at
    DccrnConfig()'s widths and the default STFT."""
    import dataclasses

    from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
    from idccrn_vae_torch.losses.phase2 import EteTrainSeLoss, TwoPhaseLoss
    from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
    from idccrn_vae_torch.train.nsvae import NsvaeTrainer
    from idccrn_vae_torch.train.phase2 import Phase2Trainer
    from idccrn_vae_torch.train.pretrain import PretrainTrainer
    from idccrn_vae_torch.train.supervised import SupervisedTrainer

    base = _fullwidth_base(compute)
    kw = dict(seed=SEED + 110, device=device)
    if case.startswith("pretrain"):
        cfg = dataclasses.replace(
            base, num_samples=2,
            skip_mode="zero" if case == "pretrain_zero" else "real")
        loss = PretrainVaeLoss(np.asarray([0.1, 0.5], np.float32), 0.05,
                               mi_weight=0.2, num_samples=2,
                               recon_loss_weight=(1.0, 0.5, 0.1))
        return PretrainTrainer(cfg, loss, FULLWIDTH_LR, **kw)
    if case == "nsvae":
        noisy = dataclasses.replace(base, latent_num=2)
        loss = NsvaeTrueKlLoss(0.8, 0.3, 1.0, 0.5, noisy, matching="both")
        return NsvaeTrainer(base, noisy, loss, FULLWIDTH_LR,
                            trainable={"clean_enc": True}, **kw)
    if case.startswith("phase2"):
        enc = dataclasses.replace(base, latent_num=2)
        dec = dataclasses.replace(enc, skip_mode="runtime", recon_type="mask")
        adv = case == "phase2_adv"
        return Phase2Trainer(enc, dec, TwoPhaseLoss((1.0, 0.5, 0.2),
                                                    alpha=1.0, latent_num=2),
                             FULLWIDTH_LR, adversarial=adv,
                             dis_lr=2 * FULLWIDTH_LR, d_step=1, **kw)
    cfg = dataclasses.replace(base, causal=True, recon_type="mask",
                              skip_mode="real")
    gen = torch.Generator().manual_seed(SEED + 111)
    bins = cfg.stft.n_fft // 2 + 1
    dn = ((0.01 * torch.randn(bins, 2, generator=gen)).numpy(),
          (1.0 + 0.1 * torch.rand(bins, 2, generator=gen)).numpy())
    return SupervisedTrainer(cfg, EteTrainSeLoss((1.0, 1.0, 0.5)),
                             FULLWIDTH_LR, datanorm=dn, **kw)


def _fullwidth_step(case: str, compute: str, device: str, weights, batch,
                    eps):
    """One step of `case` from `weights`: (losses, {model: gradients})."""
    trainer = _fullwidth_trainer(case, compute, device)
    for name, module in trainer.models.items():
        module.load_state_dict(weights[name])
    if case.startswith("pretrain"):
        metrics = trainer.train_step(batch, None, 1, noise=eps[0])
    elif case.startswith("phase2"):
        metrics = trainer.train_step(batch, None, 0, *eps)
    else:
        metrics = trainer.train_step(batch, None, 0)
    losses = {k: float(v) for k, v in metrics.items()}
    return losses, {n: _grads(m) for n, m in trainer.models.items()}


def _jax_bf16_record(case: str):
    """({"loss:<k>" or "model:<m>": the JAX bf16 step's largest distance
    from JAX f32 over the CPU tool's seeds}, the tool's setting)."""
    with open(os.path.join(REPO, FULLWIDTH_JSON)) as f:
        report = json.load(f)
    out = {}
    for rec in report["cases"][case].values():
        for key, row in rec["bf16"]["rows"].items():
            out[key] = max(out.get(key, 0.0), row["jax"])
    return out, report["setting"]


def _fullwidth_distances(case: str, b: int, samples: int, device: str):
    """One step of `case` at f32 (TF32 off) and at bf16 on `device`, B=b
    segments of `samples`, from the same weights and draws: {"loss:<k>" or
    "model:<m>": bf16's distance from f32} and the three parameters
    furthest from f32 (BN-fed conv biases aside)."""
    gen = torch.Generator().manual_seed(SEED + 112)
    k = 1 if case.startswith("pretrain") else (
        2 if case == "supervised" else 3)
    wavs = tuple(0.1 * torch.randn(b, samples, generator=gen)
                 for _ in range(k))
    batch = tuple(x.to(device) for x in wavs) if k > 1 else \
        wavs[0].to(device)
    cfg = _fullwidth_base("f32")
    frames = samples // cfg.stft.hop + 1
    s = 2 if case.startswith("pretrain") else 1
    eps = [tuple(torch.randn(b, s, frames, cfg.zdim, generator=gen)
                 .to(device) for _ in range(2)) for _ in range(2)]
    init = _fullwidth_trainer(case, "f32", "cpu")
    weights = {n: m.state_dict() for n, m in init.models.items()}
    with _NoTf32():
        l32, g32 = _fullwidth_step(case, "f32", device, weights, batch, eps)
    l16, g16 = _fullwidth_step(case, "bf16", device, weights, batch, eps)
    _check(set(l16) == set(l32), f"fullwidth_bf16_step {case}: losses")
    out = {f"loss:{k}": abs(l16[k] - l32[k]) / abs(l32[k]) if l32[k] != 0
           else abs(l16[k]) for k in l32}
    worst = []
    for n in g32:
        if not g32[n]:  # frozen
            continue
        keys = sorted(g32[n])
        out[f"model:{n}"] = _rel_l2(
            torch.cat([g16[n][p].flatten() for p in keys]),
            torch.cat([g32[n][p].flatten() for p in keys]))
        # a conv bias ahead of a train-mode BN has a gradient of rounding
        worst += [(_rel_l2(g16[n][p], g32[n][p]), f"{n}.{p}") for p in keys
                  if float(g32[n][p].norm()) > 0
                  and not (p.endswith("bias") and "conv" in p)]
    for key, v in out.items():
        _check(np.isfinite(v), f"fullwidth_bf16_step {case} {key}")
    return out, sorted(worst, reverse=True)[:3]


def phase_fullwidth_bf16_step(device: str, smi: str) -> None:
    """Each case's step, bf16 against f32 (TF32 off) from the same weights
    and draws, at two sizes. At the CPU tool's batch and segment it runs
    on the card and on this host's CPU: every loss component's relative
    error and every trained model's whole-gradient relative L2 on the card
    is held to YARD_RATIO times the port's on the CPU plus YARD_FLOOR,
    and printed beside the JAX package's largest bf16 distance that the
    tool recorded (FULLWIDTH_PARITY_TORCH.json, which holds the port's CPU
    step to the same yardstick against JAX: card ~ CPU port ~ JAX). At the
    ini's batch of 3 s segments it runs on the card and is printed beside
    the same record: no reference runs at that size (a CPU step there
    takes minutes), and the phase-2 steps' bf16 distance there, from the
    port's seeded init and these batches, reads 0.42-0.57 against 0.11 at
    the tool's size (PERF.md, section 6)."""
    t_phase = time.perf_counter()
    for case, ini_b in FULLWIDTH_CASES.items():
        t0 = time.perf_counter()
        jax_d, setting = _jax_bf16_record(case)
        ratio, floor = setting["yard_ratio"], setting["yard_floor"]
        b, samples = setting["batch"], setting["samples"]
        cpu, _ = _fullwidth_distances(case, b, samples, "cpu")
        over = []
        for size, b, samples in (("cpu_tool", b, samples),
                                 ("ini", ini_b, TRAIN_SEGMENT)):
            got, worst = _fullwidth_distances(case, b, samples, device)
            _check(set(got) == set(jax_d) == set(cpu),
                   f"fullwidth_bf16_step {case}: rows {sorted(got)}")
            held = size == "cpu_tool"
            for key in sorted(got):
                fields = dict(card_bf16_vs_f32=f"{got[key]:.4e}")
                if held:
                    bound = ratio * cpu[key] + floor
                    fields.update(cpu_port_bf16_vs_f32=f"{cpu[key]:.4e}",
                                  bound=f"{bound:.4e}")
                    if got[key] > bound:
                        over.append(f"{key} {got[key]:.4e} > {bound:.4e}")
                _line("fullwidth_bf16_step", case=case, size=size, batch=b,
                      frames=samples // 100 + 1, what=key, **fields,
                      jax_cpu_tool_bf16_vs_f32=f"{jax_d[key]:.4e}",
                      card=json.dumps(smi))
            _line("fullwidth_bf16_step", case=case, size=size,
                  worst_params=json.dumps([(p, float(f"{d:.4g}"))
                                           for d, p in worst]))
        _line("fullwidth_bf16_step", case=case,
              seconds=f"{time.perf_counter() - t0:.1f}")
        _check(not over, f"fullwidth_bf16_step {case}: {'; '.join(over)}")
    _line("fullwidth_bf16_step", seconds=f"{time.perf_counter() - t_phase:.1f}")


TOOL_ARGS = {"bench": ["--iters", "3"],
             "train_bench": ["--steps", "1"],
             "stream_bench": ["--iters", "10"],
             "profile_decoder": ["--iters", "3"],
             "profile_train": ["--steps", "1"]}


def _shares(report, path: str = ""):
    """(path, value) of every MFU in a report."""
    if isinstance(report, dict):
        for k, v in report.items():
            if k == "mfu" or k.startswith("mfu_"):
                yield f"{path}/{k}", v
            else:
                yield from _shares(v, f"{path}/{k}")
    elif isinstance(report, list):
        for i, v in enumerate(report):
            yield from _shares(v, f"{path}/{i}")


def _run_tool(name: str, out_dir: str, device, extra=()) -> dict:
    """One tool's main() with TOOL_ARGS on `device`; its report, every
    number finite and every share of the card in (0, 1]."""
    import importlib

    from idccrn_vae_torch.tools.common import finite

    tool = importlib.import_module(f"idccrn_vae_torch.tools.{name}")
    out = os.path.join(out_dir, f"{name}.json")
    t0 = time.perf_counter()
    report = tool.main(["--device", str(device), "--out", out,
                        *TOOL_ARGS[name], *extra])
    wall = time.perf_counter() - t0
    with open(out) as f:
        written = json.load(f)
    finite(written)
    shares = list(_shares(written))
    bad = [(p, v) for p, v in shares if v is not None and not 0 < v <= 1.0]
    _check(not bad, f"{name}: shares outside (0, 1]: {bad[:3]}")
    _line(f"tools_{name}", wall_s=f"{wall:.1f}", shares=len(shares),
          args=" ".join(TOOL_ARGS[name] + list(extra)))
    return report


def phase_tools(device, smi: str, weights, wav, noise, ref) -> None:
    """The five tools on the card; bench's clean_direct program at f32
    against the f32 phase's Enhancer output (`ref`, same weights and
    latent draws, TF32 off)."""
    import tempfile

    from idccrn_vae_torch.tools import bench

    cfg = _config("f32")
    with _NoTf32():
        got = bench.clean_direct(cfg, *weights, torch.device(device))(
            wav.to(device), noise=noise)
        torch.cuda.synchronize()
    _check_close("tools_bench_f32", got, ref, F32_REL,
                 vs="Enhancer clean_direct (the f32 phase)", tf32="off")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as root:
        rep = _run_tool("bench", root, device)
        for run in rep["runs"]:
            for b in run["batches"]:
                _line("tools_bench", program=run["program"],
                      compute=run["compute"], batch=b["batch"],
                      rtfx=f"{b['rtfx']:.1f}",
                      ms_per_batch=f"{b['ms_per_batch']:.2f}",
                      peak_gib=b["peak_gib"], card=json.dumps(smi))
        torch.cuda.empty_cache()
        rep = _run_tool("train_bench", root, device)
        for r in rep["results"]:
            _check(r["status"] == "ok", f"train_bench {r} is not ok")
            _line("tools_train", trainer=r["trainer"], batch=r["batch"],
                  compute=r["compute"], remat=r.get("remat", False),
                  step_ms=f"{r['step_ms']:.1f}", peak_gib=r["peak_gib"])
        torch.cuda.empty_cache()
        rep = _run_tool("stream_bench", root, device)
        for r in rep["configs"]:
            _line("tools_stream", batch=r["batch"],
                  chunk_frames=r["chunk_frames"], compute=r["compute"],
                  per_chunk_ms=f"{r['per_chunk_ms']:.3f}")
        _line("tools_stream", lstm_probe_us=json.dumps(
            rep["lstm_probe_us"]))
        rep = _run_tool("profile_decoder", root, device)
        for r in rep["results"]:
            _check(r["subpixel_max_abs_err_f32"] < 1e-3,
                   f"sub-pixel stage {r['stage']}")
        _line("tools_decoder", totals_ms=json.dumps(rep["totals_ms"]),
              mfu_useful=",".join(f"{r['mfu_current_useful']:.3f}"
                                 for r in rep["results"]))
        torch.cuda.empty_cache()
        rep = _run_tool("profile_train", root, device)
        ratio = rep["decoder_conv_crosscheck"]["counted_over_analytic"]
        _line("tools_profile", **{k: f"{v['ms']:.1f}ms/mfu={v['mfu']:.4f}"
                                  for k, v in rep["programs"].items()},
              decoder_counted_over_analytic=f"{ratio:.4f}")
        _check(1.0 <= ratio < 1.25, f"decoder FLOP cross-check {ratio}")


# ------------------------------------------------------ utils, quickstart

UTILS_BATCH = 32
UTILS_ITERS = 10


def _kernel_events(trace_path: str) -> int:
    """Device kernel events in a Chrome trace written by torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel")


def phase_utils(weights, device: str, smi: str, trace_dir) -> None:
    """utils/profiling.py and utils/debug.py on the card, around the bf16
    clean_direct forward at B=32 (3 s clips)."""
    import tempfile

    from idccrn_vae_torch.utils.debug import check_finite, checkify_finite
    from idccrn_vae_torch.utils.profiling import (
        StepTimer,
        log_memory,
        trace,
    )

    enh = _enhancer("bf16", weights, device)
    gen = enh.new_generator(SEED)
    wav = 0.1 * torch.randn(UTILS_BATCH, CLIP_S * FS, device=device,
                            generator=gen)
    enh.enhance_batch(wav, gen)  # warm: cuDNN plans, the allocator
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_utils_") as tmp:
        with trace(trace_dir or tmp) as prof:
            out = enh.enhance_batch(wav, gen)
        kernels = _kernel_events(prof.trace_path)
        trace_mb = os.path.getsize(prof.trace_path) / 1e6
    _check(kernels > 0, "utils trace holds no CUDA kernel event")
    _check(bool(torch.isfinite(out).all()), "utils forward is not finite")
    _line("utils_trace", batch=UTILS_BATCH, compute="bf16",
          kernel_events=kernels, trace_mb=f"{trace_mb:.2f}")

    timer = StepTimer("clean_direct")
    for _ in range(UTILS_ITERS):
        timer.__enter__()
        out = enh.enhance_batch(wav, gen)
        timer.block_and_stop(out)
    summary = timer.summary()
    _check(summary["count"] == UTILS_ITERS, f"StepTimer {summary}")
    _line("utils_timer", batch=UTILS_BATCH, compute="bf16",
          **{(k if k == "count" else k[:-2] + "_ms"):
             (v if k == "count" else f"{1e3 * v:.2f}")
             for k, v in summary.items()},
          rtfx=f"{UTILS_BATCH * CLIP_S / summary['mean_s']:.1f}",
          card=json.dumps(smi))

    mem = log_memory()
    _check(mem.get("0_peak_bytes_mb", 0) > 0, f"log_memory {mem}")
    _line("utils_memory", **{k: f"{v:.1f}" for k, v in mem.items()},
          card=json.dumps(smi))

    check_finite({"encoder": enh.encoder, "decoder": enh.decoder},
                 "enhancer")
    bad = torch.tensor([1.0, float("nan"), 2.0], device=device)
    _check(checkify_finite(bad[::2], "finite") is not None, "checkify")
    try:
        checkify_finite(bad, "bad")
        raised = None
    except RuntimeError as e:
        raised = str(e)
    _check(raised == "NaN/Inf detected in bad", f"checkify_finite {raised}")
    # the check reads its flag on the host: the CUDA context stays usable
    after = (torch.ones(4, device=device) * 2).sum().item()
    _check(after == 8.0, "the card failed after checkify_finite raised")
    _line("utils_debug", check_finite="enhancer weights finite",
          checkify_finite=json.dumps(raised), context_after="ok")


def phase_quickstart(smi: str) -> None:
    """idccrn_vae_torch.examples.quickstart on the card (its default
    device) in a temp dir: every stage's checkpoint dir, the evaluation's
    scores and the streamed wav."""
    import tempfile

    from idccrn_vae_torch.data.audio_io import read_wav
    from idccrn_vae_torch.examples import quickstart

    with tempfile.TemporaryDirectory(prefix="chip_smoke_qs_") as root:
        seconds = quickstart.main([root])
        for name in ("cvae", "nvae", "nsvae", "p2"):
            run = quickstart.latest(root, name)
            _check({"meta.json", "best.pt"} <= set(os.listdir(run)),
                   f"quickstart {name} checkpoint")
        with open(os.path.join(root, "eval", "per_utterance.json")) as f:
            scores = json.load(f)
        _check(len(scores) == 4 and all(
            np.isfinite(v) for row in scores.values() for v in row.values()),
            "quickstart scores")
        wav, _ = read_wav(os.path.join(root, "stream", "streamed.wav"))
        _check(wav.shape == (3000,) and bool(np.isfinite(wav).all()),
               f"quickstart stream {wav.shape}")
    _line("quickstart", **{f"{k}_s": f"{v:.2f}" for k, v in seconds.items()},
          total_s=f"{sum(seconds.values()):.2f}", card=json.dumps(smi))


# The kernel against its plain path at bf16: both read the same bf16
# q, k, v and table and sum in float32; the kernel rounds the softmax's
# probabilities to bf16 for P v (2**-9 relative each, averaged over the
# keys) and the answer to bf16 (2**-9). A dropped or misplaced relative
# term reads tens of percent.
CMGAN_KERNEL_REL_L2 = 1e-2
CMGAN_SHAPES = ((808, 2600, True), (8 * 2600, 101, False))
KERNELS = []


def _cuda_ms(fn, iters: int) -> float:
    """Device ms per call of fn over `iters` warm calls (CUDA events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_cmgan_kernel(device: str, smi: str) -> None:
    from idccrn_vae_torch.ops import rel_attention as ra

    heads, d, table = 4, 16, 1025
    for rows, n, masked in CMGAN_SHAPES:
        g = torch.Generator(device=device).manual_seed(SEED + rows + n)
        # as models/cmgan.py makes them: views of one (rows, n, 3, heads,
        # d) product
        qkv = torch.randn(rows, n, 3, heads, d, device=device,
                          generator=g).to(torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        emb = torch.randn(table, d, device=device, generator=g).to(
            torch.bfloat16)
        lens = None
        keys = rows * n
        if masked:
            lens = torch.randint(1, n + 1, (rows,), device=device,
                                 generator=g)
            lens[0], lens[1] = n, 1
            keys = int(lens.sum())
        ra.COUNTERS["kernel_launches"] = 0
        got = ra.rel_attention(q, k, v, emb, lens)
        torch.cuda.synchronize()
        _check(ra.COUNTERS["kernel_launches"] == 1,
               f"cmgan_kernel launches {ra.COUNTERS}")
        want = ra.rel_attention_plain(q, k, v, emb, lens, block=64)
        _check(bool(torch.isfinite(got.float()).all()),
               "cmgan_kernel answer is not finite")
        err = _rel_l2(got, want)
        _check(err < CMGAN_KERNEL_REL_L2, f"cmgan_kernel rel L2 {err}")
        ms = _cuda_ms(lambda: ra.rel_attention(q, k, v, emb, lens), 10)
        plain_ms = _cuda_ms(lambda: ra.rel_attention_plain(
            q, k, v, emb, lens, block=64), 2)
        flops = 6 * heads * n * keys * d
        moved = 2 * (4 * rows * heads * n * d + table * d)
        bound_ms = 1e3 * max(flops / 989.4e12, moved / 3.35e12)
        entry = {"name": "rel_attn_fwd",
                 "source": "idccrn_vae_torch/csrc/rel_attention.cu",
                 "shape": f"rows={rows} n={n} heads={heads} d={d} "
                          f"masked={masked}",
                 "ms": round(ms, 4), "bound_ms": round(bound_ms, 4),
                 "plain_ms": round(plain_ms, 3), "library_ms": None,
                 "rel_l2": err}
        KERNELS.append(entry)
        _line("cmgan_kernel", rows=rows, n=n, masked=masked, keys=keys,
              rel_l2=f"{err:.3e}", tol=CMGAN_KERNEL_REL_L2,
              ms=f"{ms:.3f}", bound_ms=f"{bound_ms:.3f}",
              roofline=f"{100 * bound_ms / ms:.2f}%",
              plain_ms=f"{plain_ms:.1f}", card=json.dumps(smi))
        del qkv, q, k, v, got, want


def phase_cmgan_serve(device: str, smi: str) -> None:
    from idccrn_vae_torch.eval.enhance import CmganEnhancer
    from idccrn_vae_torch.models.cmgan import TSCNet
    from idccrn_vae_torch.ops import rel_attention as ra

    torch.manual_seed(SEED)
    state = TSCNet().state_dict()   # PyTorch's default inits
    for name, t in state.items():
        if name.endswith("rel_pos_emb.weight"):
            t.normal_()
    enh = CmganEnhancer(state, compute="bf16", device=device)
    rng = np.random.default_rng(SEED)
    pool = [(0.1 * rng.standard_normal(s * FS - i)).astype(np.float32)
            for s in (16, 6) for i in range(8)]
    enh.enhance_utterances(pool, 8)   # warm: the build, cuDNN's plans
    torch.cuda.synchronize()
    batches = -enh.counters["batches"]
    ra.COUNTERS["kernel_launches"] = 0
    t0 = time.perf_counter()
    outs = enh.enhance_utterances(pool, 8)
    wall = time.perf_counter() - t0
    launches = ra.COUNTERS["kernel_launches"]
    batches += enh.counters["batches"]
    _check(all(o.shape == w.shape and np.isfinite(o).all()
               for o, w in zip(outs, pool)), "cmgan_serve answers")
    _check(batches == 2 and launches == 8 * batches,
           f"cmgan_serve: {launches} launches over {batches} batches")
    audio = sum(len(w) for w in pool) / FS
    _line("cmgan_serve", utterances=len(pool), batches=batches,
          kernel_launches=launches, audio_s=f"{audio:.1f}",
          wall_s=f"{wall:.3f}", rtfx=f"{audio / wall:.1f}",
          peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          card=json.dumps(smi))


# The kernel against the eager loop, relative L2 of out and the final h
# and c: the derivation and the readings are in
# tests/test_torch_port_lstm_kernel.py
LSTM_KERNEL_REL_L2 = {"bf16": 7e-4, "f32": 1e-5}
# (name, S, N, H, T, compute, carry): the benchmark cells' layer calls,
# then the float32 dual program at batch 128, where a block walks the
# most chunks of rows (16) a step
LSTM_SHAPES = (("z128_eval", 2, 16, 384, 1701, "bf16", False),
               ("dual_eval", 2, 16, 768, 1701, "bf16", False),
               ("serve", 2, 256, 384, 501, "bf16", False),
               ("stream", 2, 2, 384, 10, "f32", True),
               ("dual_f32_b128", 2, 256, 768, 501, "f32", False))


def phase_lstm_kernel(device: str, smi: str) -> None:
    from idccrn_vae_torch.ops import lstm

    for name, s, n, hid, t_len, compute, carry in LSTM_SHAPES:
        cdt = torch.bfloat16 if compute == "bf16" else torch.float32
        g = torch.Generator(device=device).manual_seed(SEED + n + hid)
        xp = torch.randn(s, t_len, n, 4 * hid, device=device, generator=g)
        w_hh = ((torch.rand(s, 4 * hid, hid, device=device, generator=g)
                 * 2 - 1) * hid ** -0.5).to(cdt).float()
        state = None
        if carry:
            state = (torch.randn(s, n, hid, device=device, generator=g)
                     .tanh().to(cdt),
                     torch.randn(s, n, hid, device=device, generator=g))
        cudnn = torch.nn.LSTM(hid, hid).to(device, torch.bfloat16)
        cudnn.flatten_parameters()
        seq = torch.randn(t_len, s * n, hid, device=device, generator=g).to(
            torch.bfloat16)
        with torch.no_grad():
            lstm.COUNTERS["kernel_launches"] = 0
            out, (h, c) = lstm._layer(xp, w_hh, cdt, state)
            torch.cuda.synchronize()
            _check(lstm.COUNTERS["kernel_launches"] == 1,
                   f"lstm_kernel {name} launches {lstm.COUNTERS}")
            want, (want_h, want_c) = lstm._layer_plain(xp, w_hh, cdt, state)
            err = max(_rel_l2(out, want), _rel_l2(h, want_h),
                      _rel_l2(c, want_c))
            _check(bool(torch.isfinite(out.float()).all()),
                   f"lstm_kernel {name} answer is not finite")
            _check(err < LSTM_KERNEL_REL_L2[compute],
                   f"lstm_kernel {name} rel L2 {err}")
            ms = _cuda_ms(lambda: lstm._layer_cuda(xp, w_hh, cdt, state), 10)
            plain_ms = _cuda_ms(lambda: lstm._layer_plain(xp, w_hh, cdt,
                                                          state), 2)
            library_ms = _cuda_ms(lambda: cudnn(seq), 10)
        size = 2 if compute == "bf16" else 4
        flops = 2 * s * n * 4 * hid * hid * t_len
        moved = (4 * (xp.numel() + c.numel())
                 + size * (w_hh.numel() + out.numel())
                 + (0 if state is None else (size + 4) * s * n * hid))
        peak = 989.4e12 if compute == "bf16" else 66.9e12
        bound_ms = 1e3 * max(flops / peak, moved / 3.35e12)
        KERNELS.append({"name": "lstm_recurrence",
                        "source": "idccrn_vae_torch/csrc/lstm_recurrence.cu",
                        "shape": f"{name}: S={s} N={n} H={hid} T={t_len} "
                                 f"{compute} carry={carry}",
                        "ms": round(ms, 4), "bound_ms": round(bound_ms, 4),
                        "plain_ms": round(plain_ms, 3),
                        "library_ms": round(library_ms, 4), "rel_l2": err})
        _line("lstm_kernel", shape=name, s=s, n=n, h=hid, t=t_len,
              compute=compute, carry=carry, rel_l2=f"{err:.3e}",
              tol=LSTM_KERNEL_REL_L2[compute], ms=f"{ms:.3f}",
              us_per_step=f"{1e3 * ms / t_len:.2f}",
              bound_ms=f"{bound_ms:.4f}",
              roofline=f"{100 * bound_ms / ms:.2f}%",
              plain_ms=f"{plain_ms:.2f}", library_ms=f"{library_ms:.3f}",
              card=json.dumps(smi))
        del xp, w_hh, out, want, cudnn, seq


def phase_lstm_enhancer(weights, device: str, smi: str) -> None:
    from idccrn_vae_torch.models.modules import ComplexLSTM
    from idccrn_vae_torch.ops import lstm

    enh = _enhancer("bf16", weights, device)
    layers = []   # the layers of each ComplexLSTM call
    for m in enh.encoder.modules():
        if isinstance(m, ComplexLSTM):
            m.register_forward_hook(
                lambda mod, *_: layers.append(len(mod.lstm_re.layers())))
    rng = np.random.default_rng(SEED + 5)
    wavs = [(0.1 * rng.standard_normal(10 * FS - i)).astype(np.float32)
            for i in range(8)]
    enh.enhance_utterances(wavs, batch_size=8)   # warm: the kernel's build
    torch.cuda.synchronize()
    layers.clear()
    lstm.COUNTERS.update(kernel_launches=0, loop_steps=0)
    t0 = time.perf_counter()
    outs = enh.enhance_utterances(wavs, batch_size=8)
    wall = time.perf_counter() - t0
    counts = dict(lstm.COUNTERS)
    _check(all(o.shape == w.shape and np.isfinite(o).all()
               for o, w in zip(outs, wavs)), "lstm_enhancer answers")
    _check(len(layers) >= 1 and counts["kernel_launches"] == sum(layers)
           and counts["loop_steps"] == 0,
           f"lstm_enhancer: {counts} over ComplexLSTM calls of {layers} "
           "layers")
    _line("lstm_enhancer", utterances=len(wavs), complex_lstm_calls=len(layers),
          kernel_launches=counts["kernel_launches"],
          loop_steps=counts["loop_steps"], wall_s=f"{wall:.3f}",
          rtfx=f"{sum(len(w) for w in wavs) / FS / wall:.1f}",
          card=json.dumps(smi))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-dir", default=None,
                    help="also write the profiler trace and table here")
    ap.add_argument("--only", action="append",
                    choices=["serving", "eval", "train", "fullwidth",
                             "tools", "utils", "quickstart", "cmgan",
                             "lstm"],
                    help="run only these groups of phases (repeatable; "
                         "default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs "
              "only on the card", file=sys.stderr)
        return 2
    device = "cuda"
    groups = set(args.only or ("serving", "eval", "train", "fullwidth",
                               "tools", "utils", "quickstart", "cmgan",
                               "lstm"))
    if "eval" in groups:  # the CLIs read the serving phases' weights
        groups.add("serving")
    t_start = time.perf_counter()
    smi = phase_device(device)
    weights = _weights(_config("f32"))
    wav_f32 = None
    if "serving" in groups:
        t_phase = time.perf_counter()
        wav_f32, noise_f32, ref_f32 = phase_f32(weights, device)
        phase_bf16(weights, device, wav_f32, noise_f32, ref_f32)
        enh = _enhancer("bf16", weights, device)
        phase_serving(enh)
        phase_throughput(enh, device, smi)
        for b in THROUGHPUT_BATCHES:
            phase_trace(enh, device, args.trace_dir, b)

        dual = _dual_weights()
        wav, eps, f32_spec, f32_outs = phase_dual_f32(dual, device)
        phase_dual_bf16(dual, device, wav, eps, f32_spec, f32_outs)
        dual_enh = _dual_enhancer("bf16", dual, device, "complex_mask")
        phase_throughput(dual_enh, device, smi, iters=10,
                         phase="dual_throughput", outtype="complex_mask")
        phase_trace(dual_enh, device, args.trace_dir, THROUGHPUT_BATCHES[0],
                    phase="dual_trace")
        phase_streaming(weights, device, smi, args.trace_dir)
        supervised = phase_supervised(device, smi)
        vae = phase_vae_recon(device)
        phase_dnsmos(device, smi)
        phase_int8(weights, device, smi, wav_f32, noise_f32, ref_f32)
        phase_export(weights, device, smi)
        _line("serving_phases",
              seconds=f"{time.perf_counter() - t_phase:.1f}")

    import tempfile

    if "eval" in groups:
        t_eval = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            corpus = _make_corpus(os.path.join(root, "corpus"))
            dirs = _write_checkpoints(os.path.join(root, "ckpt"), weights,
                                      supervised, vae)
            phase_eval_cli(dirs, corpus, root, smi)
            phase_dnsmos_cli(root, smi)
            phase_prevae_cli(dirs, corpus, root, smi)
            phase_supervised_cli(dirs, corpus, root, smi)
            phase_stream_cli(dirs, corpus, root, smi)
            phase_export_cli(dirs, corpus, root, smi)
            phase_eval_cli_int8(dirs, corpus, root, smi)
        _line("eval_phases", seconds=f"{time.perf_counter() - t_eval:.1f}",
              what="corpus, checkpoints and the CLI phases")

    if "train" in groups:
        t_train = time.perf_counter()
        walls = {}

        def timed(name, fn, *a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            walls[name] = f"{time.perf_counter() - t0:.1f}"
            return out

        trainer, batch = timed("pretrain_step", phase_pretrain_step, device,
                               smi)
        timed("train_trace", phase_train_trace, trainer, batch,
              args.trace_dir)
        del trainer, batch
        timed("nsvae_step", phase_nsvae_step, device, smi)
        encoder = _nsvae_trainer("f32", "cpu").models[
            "noisy_enc"].state_dict()
        timed("phase2_step", phase_phase2_step, device, smi, encoder,
              adversarial=False)
        trainer, batch = timed("adv_step", phase_phase2_step, device, smi,
                               encoder, adversarial=True)
        timed("adv_trace", phase_adv_trace, trainer, batch, args.trace_dir)
        del trainer, batch
        timed("supervised_step", phase_supervised_step, device, smi)
        torch.cuda.empty_cache()
        timed("ddp", phase_ddp, device, smi)
        timed("remat", phase_remat, device, smi)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
            dirs, runs = timed("train_cli", phase_train_cli, root, smi)
            timed("train2_cli", phase_train2_cli, root, smi, dirs, runs)
            timed("ddp_cli", phase_ddp_cli, root, smi, dirs, runs)
        _line("train_phases", seconds=f"{time.perf_counter() - t_train:.1f}",
              **{f"{k}_s": v for k, v in walls.items()})

    if "fullwidth" in groups:
        torch.cuda.empty_cache()
        phase_fullwidth_bf16_step(device, smi)

    if "tools" in groups:
        t_tools = time.perf_counter()
        torch.cuda.empty_cache()
        if wav_f32 is None:
            wav_f32, noise_f32, ref_f32 = phase_f32(weights, device)
        phase_tools(device, smi, weights, wav_f32, noise_f32, ref_f32)
        _line("tools_phases", seconds=f"{time.perf_counter() - t_tools:.1f}")

    if "utils" in groups:
        t_utils = time.perf_counter()
        torch.cuda.empty_cache()
        phase_utils(weights, device, smi, args.trace_dir)
        _line("utils_phases", seconds=f"{time.perf_counter() - t_utils:.1f}")

    if "quickstart" in groups:
        t_qs = time.perf_counter()
        phase_quickstart(smi)
        _line("quickstart_phases",
              seconds=f"{time.perf_counter() - t_qs:.1f}")

    if "cmgan" in groups:
        t_cmgan = time.perf_counter()
        torch.cuda.empty_cache()
        phase_cmgan_kernel(device, smi)
        torch.cuda.empty_cache()
        phase_cmgan_serve(device, smi)
        _line("cmgan_phases", seconds=f"{time.perf_counter() - t_cmgan:.1f}")

    if "lstm" in groups:
        t_lstm = time.perf_counter()
        torch.cuda.empty_cache()
        phase_lstm_kernel(device, smi)
        torch.cuda.empty_cache()
        phase_lstm_enhancer(weights, device, smi)
        _line("lstm_phases", seconds=f"{time.perf_counter() - t_lstm:.1f}")
    print(json.dumps({"kernels": KERNELS}))
    _line("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
