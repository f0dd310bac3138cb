"""Drive the PyTorch port's serving paths on one CUDA card and check them.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py [--trace-dir DIR]

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

The port has no hand-written kernel yet: every op of these paths is a
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
        _line(phase, **fields, batch=b, compute="bf16", num_samples=1,
              clip_s=CLIP_S, iters=iters,
              rtfx=f"{iters * b * CLIP_S / dt:.1f}",
              ms_per_batch=f"{1e3 * dt / iters:.2f}",
              peak_mem_gib=f"{peak / 2**30:.3f}", card=json.dumps(smi))


def _profiled(phase: str, run, trace_dir, stem: str, top: int = 10,
              **fields) -> None:
    """torch.profiler over one call of `run` (warm), closed by a
    synchronize: device ops, launch calls, device busy share, and the
    top device ops by self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in dev)
    busy_us = sum(e.self_device_time_total for e in dev)
    cpu_launch = sum(e.count for e in prof.key_averages()
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
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=80))


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


def phase_supervised(device: str, smi: str, iters: int = 20) -> None:
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


# -------------------------------------------------------------- vae_recon


def phase_vae_recon(device: str) -> None:
    """configs/pretrained_cvae.ini's usage line: causal, zdim 128,
    num_samples 5, --skip_padding (zero skips); with seeded datanorm."""
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

    dual = _dual_weights()
    wav, eps, f32_spec, f32_outs = phase_dual_f32(dual, device)
    phase_dual_bf16(dual, device, wav, eps, f32_spec, f32_outs)
    dual_enh = _dual_enhancer("bf16", dual, device, "complex_mask")
    phase_throughput(dual_enh, device, smi, iters=10,
                     phase="dual_throughput", outtype="complex_mask")
    phase_trace(dual_enh, device, args.trace_dir, THROUGHPUT_BATCHES[0],
                phase="dual_trace")
    phase_streaming(weights, device, smi, args.trace_dir)
    phase_supervised(device, smi)
    phase_vae_recon(device)
    # no hand-written kernel is on these paths yet
    print(json.dumps({"kernels": []}))
    _line("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
