#!/usr/bin/env python3
"""Run chip_smoke.py's slice (g4) many times on one CUDA card: a fresh
dispatcher (ops/pipeline.AsyncBatchVerifier) is given a 10,240-signature
secp256k1 block, then a 1,000-signature ed25519 block and the secp256k1
edge battery at once, and every job's verdicts are checked. It prints
how many runs gave a wrong job, by job, and the first wrong runs' rows.

    python tools/torch_mixed_submit_repeat.py [ROOT] [RUNS]

ROOT (default .) is a checkout whose package and chip_smoke.py are
imported, so a parent unpacked with `git archive` can be run beside the
tree in one call; RUNS defaults to 100. The commits are built and signed
as chip_smoke.py builds them (a spawn pool of up to 8 processes).
"""
import multiprocessing
import os
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from tendermint_tpu_torch.ops import backend, pipeline
    from tendermint_tpu_torch.ops.entry_block import EntryBlock

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cs.build_kernels()
    cs.N_VALIDATORS = cs.G4_ED
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        vals, commit = cs.build_secp_commit(pool)
        ed_vals, ed_commit = cs.build_commit(pool, "ed25519")
    items = [e for e in cs.secp_edge_entries() if len(e[2]) == 64]
    want = [cs._secp_oracle(e) for e in items]
    busy = EntryBlock.from_entries(cs.commit_entries(commit, vals), scheme="secp256k1")
    ed_block = EntryBlock.from_entries(cs.commit_entries(ed_commit, ed_vals)[: cs.G4_ED])
    secp_block = EntryBlock.from_entries(items, scheme="secp256k1")
    wrong = {"secp256k1 block": 0, "ed25519 block": 0, "secp256k1 battery": 0}
    shown = 0
    t = time.perf_counter()
    for r in range(runs):
        v = pipeline.AsyncBatchVerifier(dev, prepare=backend.prepare_block)
        try:
            futs = [v.submit(busy), v.submit(ed_block), v.submit(secp_block)]
            got = [f.result(timeout=600) for f in futs]
        finally:
            v.close()
        bad = (not got[0].all(), not got[1].all(), got[2].tolist() != want)
        for k, b in zip(wrong, bad):
            wrong[k] += int(b)
        if any(bad) and shown < 3:
            shown += 1
            print(f"run {r}: rows of the secp256k1 block rejected: "
                  f"{np.flatnonzero(~got[0]).tolist()[:24]}", flush=True)
    print(f"{root}: {runs} runs in {time.perf_counter() - t:.1f} s; runs with a wrong job "
          f"{wrong}; {torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
