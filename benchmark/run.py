"""Run one cell of the benchmark of ``ndjir_torch`` on the cards of this
machine and print its result as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiled window.  Without
a card, or with fewer cards than the cell asks for, it exits with code 2
and prints no result.  See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# PyTorch's jiterator kernel cache (the softplus derivative's kernel) in a
# fixed directory of the checkout, so that only a checkout's first run
# compiles it
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(HERE, "cache",
                                                       "kernels")
# one host thread for the CPU libraries' pools: the trainer's dispatch
# shares the machine's cores with nothing else of the run
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
