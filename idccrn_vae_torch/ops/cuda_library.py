"""The port's hand-written CUDA kernels (`idccrn_vae_torch/csrc/*.cu`),
built and bound at their first use.

`function(stem, name, argtypes)` compiles `csrc/<stem>.cu` with nvcc for
the current card into `csrc/build/<stem>_<hash>.so`, the hash taken over
the source and the architecture (`sm_90a` on Hopper), loads it with
ctypes (a later process finds it built) and returns its C function
`name`, which returns a CUDA error (0: none). The wrappers are
`ops/lstm.py` and `ops/rel_attention.py`. Nothing is built where no
kernel launches (the CPU).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")

# the loaded libraries keep their functions' handles alive
_LIBRARIES: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def function(stem: str, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C function `name` of `csrc/<stem>.cu`, built for this card and
    loaded once a process."""
    fn = _FUNCTIONS.get((stem, name))
    if fn is None:
        if stem not in _LIBRARIES:
            _LIBRARIES[stem] = ctypes.CDLL(_built(stem))
        fn = getattr(_LIBRARIES[stem], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[(stem, name)] = fn
    return fn


def _built(stem: str) -> str:
    src = os.path.join(CSRC, f"{stem}.cu")
    major, minor = torch.cuda.get_device_capability()
    if major < 8:
        raise RuntimeError(f"{stem} needs bf16 mma (sm_80 or later), the "
                           f"card is sm_{major}{minor}")
    # the arch-specific target on Hopper, as wgmma needs
    arch = "90a" if (major, minor) == (9, 0) else f"{major}{minor}"
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + arch.encode()).hexdigest()[:16]
    out_dir = os.path.join(CSRC, "build")
    lib = os.path.join(out_dir, f"{stem}_{tag}.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), f"-gencode=arch=compute_{arch},code=sm_{arch}",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, src]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"building {stem} failed: {' '.join(cmd)}"
                               f"\n{r.stdout}{r.stderr}")
        os.replace(tmp, lib)
    return lib


def _nvcc() -> str:
    for path in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("the port's CUDA kernels are built on first use and "
                       "need nvcc (CUDA_HOME, /usr/local/cuda or PATH)")
