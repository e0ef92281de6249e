#!/usr/bin/env python3
"""Time the port's three ladder kernels and its two K2 table builds on one
CUDA card, for comparing two checkouts (or two builds of one) on one
machine.

    python tools/torch_ladder_ab.py [--root DIR] [--sweep]

imports tendermint_tpu_torch from DIR (default: this checkout), builds
its kernel library with nvcc, and prints one JSON line with:

- the card (`nvidia-smi` name and power limit);
- per timed kernel, ptxas' registers, stack frame and spill bytes (read
  by this checkout's `chip_smoke.kernel_resources`), and the SASS
  instruction, local load (LDL) and local store (STL) counts from
  `cuobjdump -sass`;
- the CUDA-event time of k3_rlc and k2_rlc at 2,560 lanes and of
  k3_ladder, k3r_ladder, k2_table and k1_decompress at 10,240
  signatures (the 10,000-validator commit's shapes), median of --rounds
  rounds of --reps launches each;
- with --sweep, the same times of k3_rlc and k2_rlc over 640 to 10,240
  lanes and of k3_ladder over 2,560 to 40,960 signatures: a time that
  grows in step with the batch says the card is full, a flat one that
  the warps' own latency bounds it.

The inputs are seeded random limbs and digits in range, not signatures:
a ladder's or a table build's work does not depend on the data, only a
ladder's table reads do, and the verdicts are not read. To compare a parent with a change, run
parent, change, change, parent on one machine; to compare block sizes,
edit the kernels' constants in copies and pass each with --root.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

LANES = 2560
SIGS = 10240
SWEEP_LANES = (640, 1280, 2560, 5120, 10240)
SWEEP_SIGS = (2560, 5120, 10240, 20480, 40960)
TIMED = ("k3_rlc", "k3_ladder", "k3r_ladder", "k2_rlc", "k2_table", "k1_decompress")
HERE = Path(__file__).resolve().parent.parent


def _sass(lib: Path) -> dict:
    """SASS instruction, LDL and STL counts per timed kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : _ZN3edw\d+(\w+?)_kernelE", line)
        if m or "Function :" in line:
            name = m.group(1) if m and m.group(1) in TIMED else None
            continue
        if name is None or not re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            continue
        rec = out.setdefault(name, {"instructions": 0, "LDL": 0, "STL": 0})
        rec["instructions"] += 1
        rec["LDL"] += " LDL" in line
        rec["STL"] += " STL" in line
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from tendermint_tpu_torch.ops import kernels, rlc, verify
    from tendermint_tpu_torch.ops import sr25519 as osr

    if not torch.cuda.is_available():
        print("torch_ladder_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    # this checkout's chip_smoke, over the package imported from --root
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build = kernels.build()
    kernels.library()
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(5)

    def limbs(rows, cols):
        return torch.randint(0, 8192, (rows, cols), generator=gen, dtype=torch.int32).to(dev)

    def digits(rows, cols):
        return torch.randint(0, 4, (rows, cols), generator=gen, dtype=torch.int32).to(dev)

    def octets(cols):
        return torch.randint(0, 256, (32, cols), generator=gen, dtype=torch.uint8).to(dev)

    def ones(rows, cols):
        return torch.ones((rows, cols), dtype=torch.int32, device=dev)

    def rlc_in(g):
        return (limbs(rlc.TBL_ROWS, g), digits(rlc.DIG_ROWS, g),
                limbs(rlc.COORD_ROWS, g), ones(2 * rlc.M, g), ones(rlc.M, g))

    def sig_in(n):
        return (limbs(verify.TBL_ROWS, n), digits(verify.DIG_ROWS, n),
                digits(verify.DIG_ROWS, n), limbs(verify.COORD_ROWS, n),
                ones(2, n), ones(1, n))

    r_in, v_in = rlc_in(LANES), sig_in(SIGS)
    k1_in = [octets(SIGS) for _ in range(4)]
    runs = {
        "k3_rlc": lambda: rlc.k3_rlc(*r_in),
        "k3_ladder": lambda: verify.k3_ladder(*v_in),
        "k3r_ladder": lambda: osr.k3r_ladder(*v_in),
        "k2_rlc": lambda: rlc.k2_rlc(r_in[2]),
        "k2_table": lambda: verify.k2_table(v_in[3]),
        "k1_decompress": lambda: verify.k1_decompress(*k1_in),
    }

    def event_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / args.reps

    if args.sweep:
        for g in SWEEP_LANES:
            runs[f"k3_rlc@{g}"] = (lambda a: lambda: rlc.k3_rlc(*a))(rlc_in(g))
            runs[f"k2_rlc@{g}"] = (lambda a: lambda: rlc.k2_rlc(a))(limbs(rlc.COORD_ROWS, g))
        for n in SWEEP_SIGS:
            runs[f"k3_ladder@{n}"] = (lambda a: lambda: verify.k3_ladder(*a))(sig_in(n))
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, fn in runs.items():
            times[name].append(event_ms(fn))
    print(json.dumps({
        "root": args.root,
        "card": card,
        "build_s": build.seconds,
        "ms": {k: statistics.median(v) for k, v in times.items()},
        "ms_rounds": times,
        "ptxas": {k: v for k, v in smoke.kernel_resources(build.ptxas).items() if k in TIMED},
        "sass": _sass(build.path),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
