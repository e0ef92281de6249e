#!/usr/bin/env python3
"""Run BASELINE config #5 (verify_headers_pipelined over chip_smoke.py's
1,000 adjacent headers of 128 validators, warm) many times on one CUDA
card and print every run's wall time, to look for a rare stalled run.

    PYTHONPATH=. python tools/torch_headers_repeat.py [RUNS] [STALL_S]

RUNS defaults to 200. Where a run passes STALL_S seconds (default 15),
faulthandler dumps every thread's stack to stderr, again every STALL_S
seconds until the run ends. The chain is built and signed as
chip_smoke.py builds it (a spawn pool, one process a core).
"""
import faulthandler
import multiprocessing
import os
import sys
import time

import torch

import chip_smoke as cs
from tendermint_tpu_torch.ops import epoch_cache, pipeline


def main() -> int:
    runs_wanted = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    stall_s = float(sys.argv[2]) if len(sys.argv) > 2 else 15.0
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    cs.build_kernels()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(16, len(os.sched_getaffinity(0)))) as pool:
        header_wire = cs.build_header_chain(pool)
    os.environ.pop("TM_TPU_RLC", None)
    epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    trusted, headers = cs._headers_from_wire(header_wire)
    runs = []
    for _ in range(runs_wanted):
        faulthandler.dump_traceback_later(stall_s, repeat=True)
        t = time.perf_counter()
        pipeline.verify_headers_pipelined(cs.HEADER_CHAIN, trusted, headers, device=dev)
        runs.append((time.perf_counter() - t) * 1e3)
        faulthandler.cancel_dump_traceback_later()
    print("runs_ms", runs, flush=True)
    print(f"runs {len(runs)}: first {runs[0]:.1f} ms, max {max(runs):.1f}, "
          f"median {sorted(runs)[len(runs) // 2]:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
