"""Streaming chunk latency on one card: the port's counterpart of
tools/stream_bench_tpu.py.

`StreamingEnhancer.process_chunk` chained over `--iters` chunks (the
state of each chunk feeds the next), at the JAX tool's configurations:
(batch, chunk frames) in (1, 1), (1, 5), (1, 10), (8, 10) at bf16, plus
(1, 10) at f32; reference geometry (zdim 128, channels 1-32-...-256,
causal, hop 100), random weights from seeded CPU generators. After one
warm chunk, three windows of `--iters` chunks, each closed by a scalar
fetch; per_chunk_ms is the best window over its chunks. realtime_margin
= chunk duration / per_chunk_ms, streams_realtime = batch x that margin.
The JAX tool chains its chunks in one `lax.fori_loop` dispatch; here each
chunk is an eager chain of launches (about 920 at 10 frames, PERF.md §5),
so the host sets the pace.

The LSTM probe times the bare 2-layer 1280 -> 128 complex LSTM of the
port (`ops/lstm.complex_lstm`, bf16) at B=1 and T = 1 and 10 frames:
stateful (each call continues the previous call's state) and stateless
(each call starts from zeros), microseconds per call.

  python -m idccrn_vae_torch.tools.stream_bench [--iters 300]
      [--tiny --device cpu]

writes STREAM_BENCH_TORCH.json (or --out) with the card record.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.tools import common

ITERS = 300
WINDOWS = 3
BF16_POINTS = ((1, 1), (1, 5), (1, 10), (8, 10))
F32_POINT = (1, 10)
LSTM_IN, LSTM_HIDDEN, LSTM_LAYERS = 1280, 128, 2


def streamer(cfg: DccrnConfig, chunk_frames: int, device, seed: int = 0):
    """A StreamingEnhancer of seeded random NsvaeEncoder/VaeDecoder
    weights."""
    from idccrn_vae_torch.eval.streaming import StreamingEnhancer
    from idccrn_vae_torch.models.nsvae import NsvaeEncoder
    from idccrn_vae_torch.models.vae import VaeDecoder

    gen = lambda k: torch.Generator().manual_seed(seed + k)
    enc = NsvaeEncoder(cfg, device="cpu", generator=gen(0)).state_dict()
    dec = VaeDecoder(cfg, device="cpu", generator=gen(1)).state_dict()
    return StreamingEnhancer(cfg, cfg, enc, dec, chunk_frames=chunk_frames,
                             device=device)


def _windows(run, iters: int, device) -> list:
    """Wall seconds of WINDOWS windows of `iters` calls of `run`, each
    opened after a synchronize and closed by a scalar fetch."""
    walls = []
    for _ in range(WINDOWS):
        common.sync(device)
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = run()
        common.fetch(out)
        walls.append(time.perf_counter() - t0)
    return walls


def bench_chunk_step(cfg: DccrnConfig, batch: int, chunk_frames: int,
                     iters: int, device, seed: int = 0) -> dict:
    s = streamer(cfg, chunk_frames, device, seed)
    m = s.chunk_samples
    gen = torch.Generator().manual_seed(seed)
    chunk = (0.1 * torch.randn(batch, m, generator=gen)).to(device)
    carry = {"state": s.init_state(batch)}

    def run():
        out, carry["state"] = s.process_chunk(carry["state"], chunk)
        return out

    common.fetch(run())  # warm: cuDNN plans, the allocator
    walls = _windows(run, iters, device)
    per_chunk_ms = min(walls) / iters * 1e3
    chunk_ms = m / common.FS * 1e3
    return {"batch": batch, "chunk_frames": chunk_frames,
            "chunk_ms": chunk_ms, "per_chunk_ms": per_chunk_ms,
            "realtime_margin": chunk_ms / per_chunk_ms,
            "streams_realtime": batch * chunk_ms / per_chunk_ms,
            "walls_s": walls, "compute": cfg.compute}


def lstm_params(device, seed: int = 0):
    """The bare complex LSTM's weights: {"re": layers, "im": layers}."""
    from idccrn_vae_torch.models.modules import ComplexLSTM

    m = ComplexLSTM(LSTM_IN, LSTM_HIDDEN, LSTM_LAYERS,
                    torch.Generator().manual_seed(seed)).to(device)
    return {"re": m.lstm_re.layers(), "im": m.lstm_im.layers()}


@torch.inference_mode()
def bench_lstm(T: int, iters: int, stateful: bool, device) -> float:
    """Microseconds per call of the 2-layer complex LSTM at B=1, T
    frames, bf16 (tools/stream_bench_tpu.py:91-): stateful calls carry
    the state from call to call."""
    from idccrn_vae_torch.ops.lstm import complex_lstm

    params = lstm_params(device)
    cdt = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    x = (0.1 * torch.randn(1, T, 2 * LSTM_IN, generator=gen)).to(device)
    carry = {"state": None}

    def run():
        if not stateful:
            return complex_lstm(x, params, compute_dtype=cdt)
        out, carry["state"] = complex_lstm(x, params, compute_dtype=cdt,
                                           state=carry["state"],
                                           return_state=True)
        return out

    common.fetch(run())
    return min(_windows(run, iters, device)) / iters * 1e6


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_args(p, "STREAM_BENCH_TORCH.json")
    p.add_argument("--iters", type=int, default=None,
                   help=f"chunks per window (default {ITERS})")
    args = p.parse_args(argv)
    device = common.device_of(args)
    geo = common.geometry(args.tiny)
    iters = args.iters or (2 if args.tiny else ITERS)
    report = {"tool": "idccrn_vae_torch.tools.stream_bench",
              "counterpart": "tools/stream_bench_tpu.py",
              "card": common.card_record(device),
              "geometry": {**geo, "causal": True, "hop": 100,
                           "tiny": args.tiny},
              "iters": iters, "windows": WINDOWS, "configs": [],
              "lstm_probe_us": {}}
    points = [(b, cf, "bf16") for b, cf in BF16_POINTS]
    points.append((*F32_POINT, "f32"))
    for batch, cf, compute in points:
        cfg = DccrnConfig(causal=True, latent_num=1, num_samples=1,
                          compute=compute, **geo)
        rec = bench_chunk_step(cfg, batch, cf, iters, device)
        report["configs"].append(rec)
        print(json.dumps(rec), flush=True)
    report["lstm_probe_geometry"] = {
        "input": LSTM_IN, "hidden": LSTM_HIDDEN, "layers": LSTM_LAYERS,
        "batch": 1, "compute": "bf16"}
    for T in (1, 10):
        probe = {"eager_stateful": bench_lstm(T, iters, True, device),
                 "eager_stateless": bench_lstm(T, iters, False, device)}
        report["lstm_probe_us"][f"T{T}_B1"] = probe
        print(f"lstm probe T={T}: {json.dumps(probe)}", flush=True)
    common.write_report(args.out, report)
    print(f"wrote {os.path.abspath(args.out)}")
    return report


if __name__ == "__main__":
    main()
