"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 benchmark/run.py --workload wb_demix --seed 7 --seconds 30 \
        --trace 0

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``checks``: each compared number beside its limit);
the same checks are the last lines of standard error.  Without a CUDA
device, or with fewer than the cell asks for, it exits 2 and prints no
result.  Caches stay inside the checkout: the kernel library builds into
``dnmf_tpu_torch/_build/`` and CUDA's JIT cache (``CUDA_CACHE_PATH``) goes to
``benchmark/.cache/``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["CUDA_CACHE_PATH"] = os.path.join(HERE, ".cache", "nv")
sys.path.insert(0, os.path.dirname(HERE))  # the checkout: dnmf_tpu_torch
sys.path.insert(0, HERE)  # cardbench, references


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    import torch

    torch.set_num_threads(2)
    from cardbench import harness

    sys.exit(harness.main(args, T_PROCESS))
