"""One run of one benchmark cell of idccrn_vae_torch on a CUDA card.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

run from the root of a checkout. It loads, warms up, measures for
--seconds, checks the window's answers against the plain reference and
prints one JSON line (see benchmark/harness.py). Without a CUDA card it
exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, heads the import path: the
# benchmark's modules import as `benchmark.*` and shadow nothing
sys.path[0] = ROOT
# build and kernel caches at fixed places inside the checkout
CACHE = os.path.join(ROOT, "benchmark", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")

if __name__ == "__main__":
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], T0))
