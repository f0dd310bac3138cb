"""What the measurement tools share: device and geometry flags, timing
windows, peak memory, the card record and the card's peak rates.

Timing: a window starts after `torch.cuda.synchronize()` and ends with a
scalar `.item()` of the last result, which waits for every launch the
window queued (the counterpart of the JAX tools' scalar fetch). The
programs are eager PyTorch: each call is a chain of launches from the
host, so where the launches are short the window measures the host as
much as the card. Where the card sits idle is read from a profiler trace
of the program's spans (`utils/profiling.py`, `benchmark/spans.py`).

Peaks: the dense rates of the NVIDIA H100 SXM5 ("NVIDIA H100 80GB
HBM3", 700 W), from NVIDIA's H100 Tensor Core GPU data sheet, without
sparsity. A card run below 700 W reaches less; the card record keeps its
power limit beside every number.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from typing import Callable, Optional

import torch

from idccrn_vae_torch.device import resolve_device
from idccrn_vae_torch.utils.profiling import device_memory, fetch, sync

PEAK_TFLOPS = {"bf16": 989.4, "tf32": 494.7, "fp32": 66.9}
PEAK_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5, dense "
               "(no sparsity)")
FS = 16000
# the tests' CPU geometry (bench.py:159-161)
TINY = dict(encoder_channels=(1, 2, 2, 4, 4, 4, 4), zdim=4)


def add_args(p: argparse.ArgumentParser, out: str) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; without "
                        "one the tool exits unless given --device cpu)")
    p.add_argument("--tiny", action="store_true",
                   help="the tests' CPU geometry and short counts: checks "
                        "the code path, its times mean nothing")
    p.add_argument("--out", default=out, help="the JSON report")


def geometry(tiny: bool) -> dict:
    """DccrnConfig fields of the measured geometry."""
    return dict(TINY) if tiny else dict(zdim=128)


def device_of(args) -> torch.device:
    return resolve_device(args.device)


def time_calls(fn: Callable, calls: int, device: torch.device,
               warm: int = 2) -> float:
    """Seconds per call of `fn()`: `warm` calls, then a window of `calls`
    opened after a synchronize and closed by a scalar fetch of the last
    result."""
    out = None
    for _ in range(warm):
        out = fn()
    if out is not None:
        fetch(out)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn()
    fetch(out)
    return (time.perf_counter() - t0) / calls


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device) -> Optional[float]:
    """Peak allocated device memory since `reset_peak`; None on the CPU."""
    if device.type != "cuda":
        return None
    return device_memory(device)[1] / 2**30


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def card_record(device: torch.device) -> dict:
    """The device the numbers come from: on a card its name, its name and
    power limit from nvidia-smi, and the versions of torch and CUDA."""
    rec = {"device": str(device), "torch": torch.__version__}
    if device.type != "cuda":
        return rec
    rec.update(name=torch.cuda.get_device_name(device),
               nvidia_smi=nvidia_smi(), cuda=torch.version.cuda,
               tf32_cudnn=torch.backends.cudnn.allow_tf32,
               tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    return rec


def peak_for(compute: str) -> tuple:
    """(TFLOP/s, its name) a program's FLOPs are held against: bf16 runs
    on the bf16 tensor cores; f32 convolutions run on TF32 tensor cores
    while cuDNN's TF32 is on (torch's default), else on the FP32 units."""
    if compute in ("bf16", "int8"):
        return PEAK_TFLOPS["bf16"], "bf16 dense"
    if torch.backends.cudnn.allow_tf32:
        return PEAK_TFLOPS["tf32"], "tf32 dense"
    return PEAK_TFLOPS["fp32"], "fp32"


def finite(obj, path: str = "") -> None:
    """Raise unless every number in the JSON-like `obj` is finite."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            finite(v, f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            finite(v, f"{path}/{i}")
    elif isinstance(obj, float) and not math.isfinite(obj):
        raise ValueError(f"{path} is {obj}")


def write_report(path: str, report: dict) -> None:
    finite(report)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
