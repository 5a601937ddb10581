"""Run one cell of the port's benchmark on the CUDA card of this machine.

    python3 cardbench/run.py --workload internlm2-1.8b.longdoc --seed 7 --seconds 30 --trace 0

Prints progress, then each number of the output check beside its limit on
standard error, then one JSON object as the last line of standard output.
Exits 2 without a result when the machine has fewer CUDA cards than the cell
asks for, and 3 when jax or the JAX package was loaded.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every build and kernel cache of the run at a fixed place in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "cardbench", sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from cardbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
