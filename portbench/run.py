"""The benchmark's command: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It sets up the cell's system from the seed,
warms it up, measures for ``--seconds``, checks what the measured window
served against the plain reference, and prints one JSON line last on
standard output. It exits non-zero, printing no result, without the CUDA
devices the cell asks for, or if the process ever held JAX or the JAX
package.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Every build and kernel cache of the program at a fixed place inside the
# checkout, so that only a checkout's first run builds (the port's nvcc
# builds go to build/torch_kernels/ beside the package by themselves).
CACHE = os.path.join(ROOT, "build", "portbench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"  # a library that could load JAX by itself
sys.path[:0] = [HERE, ROOT]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED))
