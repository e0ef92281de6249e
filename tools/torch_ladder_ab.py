#!/usr/bin/env python3
"""Time the port's ed25519, sr25519 and BLS12-381 kernels on one CUDA
card, for comparing two checkouts (or two builds of one) on one machine.

    python tools/torch_ladder_ab.py [--root DIR] [--sweep] [--only NAMES]

imports tendermint_tpu_torch from DIR (default: this checkout), builds
its kernel library with nvcc, and prints one JSON line with:

- the card (`nvidia-smi` name and power limit);
- per kernel, ptxas' registers, stack frame and spill bytes (read by this
  checkout's `chip_smoke.kernel_resources`), and the SASS instruction,
  local load (LDL), local store (STL), wide multiply (IMAD.WIDE, the
  32 x 32 -> 64 products) and carried add (IADD3.X) counts from
  `cuobjdump -sass`;
- the CUDA-event time of every kernel at the 10,000-validator commit's
  shapes: k1_rlc, k1_rlc_cached, k2_rlc and k3_rlc at 2,560 lanes, the
  per-signature and sr25519 kernels at 10,240 signatures, epoch_coords
  at 16,384 table rows; bls_miller at the BLS12-381 window's shape (16
  commits over a table of 256 rows) and bls_finalexp over its 16 Miller
  values, fused (launch A) and as 16 rows (launch B, `bls_finalexp_rows`);
  median of --rounds rounds of --reps launches;
- whether k1_rlc, k1_rlc_cached, epoch_coords, k1_decompress,
  k1_decompress_cached, k2_table, k1r_decode, bls_miller and both forms
  of bls_finalexp equal their plain versions on these inputs, every raw
  limb or word (`equal`):
  a variant timed from a copy is built and run by nothing else in the
  call, so this says whether a faster variant is also a right one;
- with --sweep, the same times of k3_rlc, k2_rlc, k1_rlc and
  k1_rlc_cached over 640 to 10,240 lanes and of k3_ladder,
  k1_decompress, k1_decompress_cached and k1r_decode over 2,560 to
  40,960 signatures: a time that grows in step
  with the batch says the card is full, a flat one that the warps' own
  latency bounds it.

The inputs are seeded random limbs, digits, bytes and field elements in
range, not signatures: a ladder's or a table build's work does not depend
on the data, only a ladder's table reads do, and the verdicts are not
read; a decompression of random bytes runs the same chain whether or not
they encode a point; the BLS kernels' work is the same on any elements.
--only (a comma-separated list of the names above) times and checks
those alone. To compare a parent with a change, run parent, change,
change, parent on one machine; to compare block sizes or other
variants, edit the kernels' constants or code in copies and pass each
with --root.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import random
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

LANES = 2560
SIGS = 10240
TABLE_ROWS = 16384
SWEEP_LANES = (640, 1280, 2560, 5120, 10240)
SWEEP_SIGS = (2560, 5120, 10240, 20480, 40960)
BLS_K, BLS_VP = 16, 256
TIMED = ("k1_rlc", "k1_rlc_cached", "k2_rlc", "k3_rlc", "epoch_coords", "k1_decompress",
         "k1_decompress_cached", "k2_table", "k3_ladder", "k1r_decode", "k3r_ladder",
         "bls_miller", "bls_finalexp")
HERE = Path(__file__).resolve().parent.parent


def _sass(lib: Path) -> dict:
    """SASS instruction, LDL, STL, IMAD.WIDE and IADD3.X counts per timed
    kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : _ZN(?:3edw|3bls)\d+(\w+?)_kernelE", line)
        if m or "Function :" in line:
            name = m.group(1) if m and m.group(1) in TIMED else None
            continue
        if name is None or not re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            continue
        rec = out.setdefault(name, {"instructions": 0, "LDL": 0, "STL": 0,
                                    "IMAD.WIDE": 0, "IADD3.X": 0})
        rec["instructions"] += 1
        for op in ("LDL", "STL", "IMAD.WIDE", "IADD3.X"):
            rec[op] += f" {op}" in line
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only", default="", help="comma-separated kernel names")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from tendermint_tpu_torch.ops import bls_verify, epoch_cache, kernels, rlc, verify
    from tendermint_tpu_torch.ops import fe_bls
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

    def rows(n):
        return torch.randint(0, 256, (n, 32), generator=gen, dtype=torch.uint8).to(dev)

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
    lane_a, lane_rt = (torch.cat([octets(LANES) for _ in range(rlc.M)]) for _ in range(2))
    scal = torch.randint(0, 256, (rlc.N_SCAL * 32, LANES), generator=gen,
                         dtype=torch.uint8).to(dev)
    pub_t = octets(TABLE_ROWS)
    ctbl, oktbl = limbs(epoch_cache.TABLE_ROWS, TABLE_ROWS), ones(1, TABLE_ROWS)
    ctbl.view(4, 32, TABLE_ROWS)[:, 20:] = 0  # a table's rows 20..31 are 0
    lane_idx = torch.randint(0, TABLE_ROWS, (LANES * rlc.M,), generator=gen,
                             dtype=torch.int32).to(dev)
    lane_r = torch.randint(0, 256, (LANES * rlc.M, 32), generator=gen, dtype=torch.uint8).to(dev)
    lane_scal = torch.randint(0, 256, (LANES, rlc.N_SCAL, 32), generator=gen,
                              dtype=torch.uint8).to(dev)
    sig_idx = torch.randint(0, TABLE_ROWS, (SIGS,), generator=gen, dtype=torch.int32).to(dev)
    warm_in = (ctbl, oktbl, sig_idx, rows(SIGS), rows(SIGS), rows(SIGS))
    sr_in = [octets(SIGS) for _ in range(4)] + [ones(1, SIGS), ones(1, SIGS)]
    warm_lanes = (ctbl, oktbl, lane_idx, lane_r, lane_scal)
    rng = random.Random(5)

    def field(*shape):
        n = 1
        for d in shape:
            n *= d
        w = fe_bls.words_from_ints([rng.randrange(bls_verify.P) for _ in range(n)])
        return torch.from_numpy(w.reshape(*shape, bls_verify.NW)).to(dev)

    masks = torch.ones((BLS_K, BLS_VP), dtype=torch.bool, device=dev)
    masks[:, -1] = False  # the padding row
    bls_in = (field(BLS_VP), field(BLS_VP), masks,
              field(BLS_K, 2, bls_verify.N_ATE, 2, 2, 2))

    @functools.cache
    def bls_want():  # the plain Miller values, whose f the final exponentiations take
        return bls_verify.verify_plain(*bls_in)

    runs = {
        "k1_rlc": lambda: rlc.k1_rlc(lane_a, lane_rt, scal),
        "k1_rlc_cached": lambda: rlc.k1_rlc_cached(*warm_lanes),
        "k2_rlc": lambda: rlc.k2_rlc(r_in[2]),
        "k3_rlc": lambda: rlc.k3_rlc(*r_in),
        "epoch_coords": lambda: epoch_cache.epoch_coords(pub_t),
        "k1_decompress": lambda: verify.k1_decompress(*k1_in),
        "k1_decompress_cached": lambda: verify.k1_decompress_cached(*warm_in),
        "k2_table": lambda: verify.k2_table(v_in[3]),
        "k3_ladder": lambda: verify.k3_ladder(*v_in),
        "k1r_decode": lambda: osr.k1r_decode(*sr_in),
        "k3r_ladder": lambda: osr.k3r_ladder(*v_in),
        "bls_miller": lambda: bls_verify.bls_miller(*bls_in),
        "bls_finalexp": lambda: bls_verify.bls_finalexp(bls_want()[1], fused=True),
        "bls_finalexp_rows": lambda: bls_verify.bls_finalexp(bls_want()[1]),
    }

    def same(got, want) -> bool:
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        return all(torch.equal(g, w) for g, w in zip(got, want))

    plain = {
        "k1_rlc": lambda: rlc.k1_rlc_plain(lane_a, lane_rt, scal),
        "k1_decompress": lambda: verify.k1_decompress_plain(*k1_in),
        "k2_table": lambda: verify.k2_table_plain(v_in[3]),
        "k1_decompress_cached": lambda: verify.k1_decompress_cached_plain(*warm_in),
        "k1_rlc_cached": lambda: rlc.k1_rlc_cached_plain(*warm_lanes),
        "epoch_coords": lambda: epoch_cache.epoch_coords_plain(pub_t),
        "k1r_decode": lambda: osr.k1r_decode_plain(*sr_in),
        "bls_miller": bls_want,
        "bls_finalexp": lambda: bls_verify.finalexp_plain(bls_want()[1], fused=True),
        "bls_finalexp_rows": lambda: bls_verify.finalexp_plain(bls_want()[1]),
    }
    if args.only:
        only = args.only.split(",")
        runs = {k: v for k, v in runs.items() if k in only}
    equal = {k: same(runs[k](), fn()) for k, fn in plain.items() if k in runs}

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
            warm = (ctbl, oktbl, torch.randint(0, TABLE_ROWS, (g * rlc.M,), generator=gen,
                                               dtype=torch.int32).to(dev),
                    rows(g * rlc.M),
                    torch.randint(0, 256, (g, rlc.N_SCAL, 32), generator=gen,
                                  dtype=torch.uint8).to(dev))
            runs[f"k1_rlc_cached@{g}"] = (lambda a: lambda: rlc.k1_rlc_cached(*a))(warm)
            cold = [torch.cat([octets(g) for _ in range(rlc.M)]) for _ in range(2)]
            cold.append(torch.randint(0, 256, (rlc.N_SCAL * 32, g), generator=gen,
                                      dtype=torch.uint8).to(dev))
            runs[f"k1_rlc@{g}"] = (lambda a: lambda: rlc.k1_rlc(*a))(cold)
        for n in SWEEP_SIGS:
            runs[f"k3_ladder@{n}"] = (lambda a: lambda: verify.k3_ladder(*a))(sig_in(n))
            warm = (ctbl, oktbl, torch.randint(0, TABLE_ROWS, (n,), generator=gen,
                                               dtype=torch.int32).to(dev),
                    rows(n), rows(n), rows(n))
            runs[f"k1_decompress_cached@{n}"] = (
                lambda a: lambda: verify.k1_decompress_cached(*a))(warm)
            cold = [octets(n) for _ in range(4)]
            runs[f"k1_decompress@{n}"] = (lambda a: lambda: verify.k1_decompress(*a))(cold)
            sr = [octets(n) for _ in range(4)] + [ones(1, n), ones(1, n)]
            runs[f"k1r_decode@{n}"] = (lambda a: lambda: osr.k1r_decode(*a))(sr)
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
        "equal": equal,
        "ptxas": {k: v for k, v in smoke.kernel_resources(build.ptxas).items() if k in TIMED},
        "sass": _sass(build.path),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
