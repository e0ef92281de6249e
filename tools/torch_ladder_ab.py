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
  `cuobjdump -sass`, with its last loop's instructions and most frequent
  opcodes (`loop`: for a ladder, one iteration);
- the CUDA-event time of every kernel at the 10,000-validator commit's
  shapes: k1_rlc, k1_rlc_cached, k2_rlc and k3_rlc at 2,560 lanes, the
  per-signature and sr25519 kernels at 10,240 signatures, epoch_coords
  at 16,384 table rows; bls_miller at the BLS12-381 window's shape (16
  commits over a table of 256 rows) and bls_finalexp over its 16 Miller
  values, fused (launch A) and as 16 rows (launch B, `bls_finalexp_rows`);
  og_verify and og_verify_cached (over an epoch table of the battery's
  keys, columns out of order) and secp_verify and secp_verify_cached (over
  a table of the secp256k1 battery's keys in reverse order) at 10,240
  signatures; median of --rounds rounds of --reps launches;
- whether k1_rlc, k1_rlc_cached, epoch_coords, k1_decompress,
  k1_decompress_cached, k2_table, k1r_decode, bls_miller, both forms
  of bls_finalexp, the two op-graph checks and the two secp256k1 kernels
  equal their plain versions on these inputs, every raw limb or word, or
  verdict for verdict (the secp256k1 kernels also every word of the
  canonical final (X, Y, Z)) (`equal`); the op-graph and secp256k1
  verdicts are also counted (`accepts`, accepted of rows):
  a variant timed from a copy is built and run by nothing else in the
  call, so this says whether a faster variant is also a right one;
- with --sweep, the same times of k3_rlc, k2_rlc, k1_rlc and
  k1_rlc_cached over 640 to 10,240 lanes and of k3_ladder,
  k1_decompress, k1_decompress_cached, k1r_decode, og_verify,
  og_verify_cached, secp_verify and secp_verify_cached over 2,560 to
  40,960 signatures: a time that grows in
  step with the batch says the card is full, a flat one that the warps'
  own latency bounds it;
- with --e2e, instead of all the above but the build, two paths around
  the secp256k1 kernels timed end to end as chip_smoke.py times them:
  the warm secp256k1 light call on 10,240 validators (slice (g1)) and
  config #4's verify_mixed (slice (g2)), two untimed calls, then
  chip_smoke.REPEATS timed ones (median, min, max in ms), with the
  launches of the timed calls and whether each gave the right result.

The inputs are seeded random limbs, digits, bytes and field elements in
range, not signatures: a ladder's or a table build's work does not depend
on the data, only a ladder's table reads do, and the verdicts are not
read; a decompression of random bytes runs the same chain whether or not
they encode a point; the BLS kernels' work is the same on any elements.
The op-graph checks' rows are signatures: chip_smoke.py's ZIP-215 edge
battery (valid, tampered, small-order, non-canonical, off-curve and
random rows) with its bucket's padding, repeated to the batch, with the
challenges from the host, so that both the accept and the reject paths
are compared. The secp256k1 kernels' rows are chip_smoke.py's secp256k1
edge battery with the two crafted rows of secp_wrap_rows and a padding
row, repeated to the batch, one accepted row tampered (its r made wrong).
--only (a comma-separated list of the names above) times and checks
those alone. To compare a parent with a change, run parent, change,
change, parent on one machine; to compare block sizes or other
variants, edit the kernels' constants or code in copies and pass each
with --root.
"""

from __future__ import annotations

import argparse
import collections
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
         "bls_miller", "bls_finalexp", "og_verify", "og_verify_cached", "secp_verify",
         "secp_verify_cached")
HERE = Path(__file__).resolve().parent.parent


def _sass(lib: Path) -> dict:
    """SASS instruction, LDL, STL, IMAD.WIDE and IADD3.X counts per timed
    kernel, and its last loop's (the body of its last backward branch,
    the ladder where the kernel has one): instructions and the counts of
    its ten most frequent opcodes (modifiers dropped but .WIDE and .X)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    out, code, name = {}, {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : _ZN(?:3edw|3bls|4secp)\d+(\w+?)_kernelE", line)
        if m or "Function :" in line:
            name = m.group(1) if m and m.group(1) in TIMED else None
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if name is None or not ins:
            continue
        rec = out.setdefault(name, {"instructions": 0, "LDL": 0, "STL": 0,
                                    "IMAD.WIDE": 0, "IADD3.X": 0})
        rec["instructions"] += 1
        for op in ("LDL", "STL", "IMAD.WIDE", "IADD3.X"):
            rec[op] += f" {op}" in line
        code.setdefault(name, []).append((int(ins.group(1), 16), ins.group(2), ins.group(3)))
    for name, body in code.items():
        at = {a: i for i, (a, _, _) in enumerate(body)}
        loops = [(at[int(t.group(1), 16)], i) for i, (a, op, args) in enumerate(body)
                 if op.startswith("BRA") and (t := re.search(r"0x([0-9a-f]+)", args))
                 and int(t.group(1), 16) < a and int(t.group(1), 16) in at]
        if loops:
            lo, hi = loops[-1]
            ops = collections.Counter(
                op.split(".")[0] + (".WIDE" if ".WIDE" in op else "") + (".X" if ".X" in op else "")
                for _, op, _ in body[lo:hi + 1])
            out[name]["loop"] = {"instructions": hi - lo + 1, "ops": dict(ops.most_common(10))}
    return out


def _e2e(smoke, dev) -> dict:
    """The warm secp256k1 light call and config #4's verify_mixed, each
    called twice, then timed over smoke.REPEATS calls: the run's stats,
    whether every timed call was right (the light call's batch stopped at
    the 2/3 mark, every mixed verdict true) and the timed calls' launches."""
    import multiprocessing
    import os
    import time

    from tendermint_tpu_torch.ops import epoch_cache, kernels, mixed
    from tendermint_tpu_torch.types.block import Commit

    workers = min(16, len(os.sched_getaffinity(0)))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        vals, commit = smoke.build_secp_commit(pool)
        ents = smoke.build_mixed(pool)
    commit = Commit.decode(commit.encode())  # as a node receives it
    epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    calls = {
        "secp_light": lambda: smoke._light_call(vals, commit, dev)[0] == smoke.SECP_LIGHT_STOP,
        "mixed": lambda: all(mixed.verify_mixed(ents, device=dev)),
    }
    out = {}
    for name, call in calls.items():
        call()
        call()
        kernels.reset_launches()
        runs, ok = [], True
        for _ in range(smoke.REPEATS):
            t = time.perf_counter()
            ok = call() and ok
            runs.append((time.perf_counter() - t) * 1e3)
        out[name] = dict(smoke._run_stats(runs), ok=ok,
                         launches={k: v for k, v in kernels.LAUNCHES.items() if v})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only", default="", help="comma-separated kernel names")
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.append(str(HERE))  # chip_smoke for --e2e's signing processes
    import torch

    import numpy as np

    from tendermint_tpu_torch.ops import bls_verify, epoch_cache, kernels, rlc, verify
    from tendermint_tpu_torch.ops import ed25519_verify as og
    from tendermint_tpu_torch.ops import fe_bls
    from tendermint_tpu_torch.ops import secp_verify as sv
    from tendermint_tpu_torch.ops import sr25519 as osr
    from tendermint_tpu_torch.ops.entry_block import EntryBlock

    if not torch.cuda.is_available():
        print("torch_ladder_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    # this checkout's chip_smoke, over the package imported from --root
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build = kernels.build()
    kernels.library()
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    dev = torch.device("cuda", 0)
    if args.e2e:
        print(json.dumps({"root": args.root, "card": card, "build_s": build.seconds,
                          "e2e": _e2e(smoke, dev)}), flush=True)
        return 0
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

    # the op-graph checks: the edge battery's rows with host challenges,
    # over an epoch table of its keys (columns out of order), repeated
    edge = EntryBlock.from_entries(smoke.edge_entries())
    block, ep = smoke.with_epoch(edge, 19)
    og_rows = og.prepare_batch(edge, device_hash=False).args  # a, r, s, k rows, s_ok
    og_idx = epoch_cache.table_columns(block, len(og_rows[-1]), ep)
    og_tbl = tuple(t.to(dev) for t in epoch_cache.epoch_coords_plain(
        torch.from_numpy(np.ascontiguousarray(ep.pub_rows.T))))

    def og_in(n):
        """(a, r, s, k, s_ok) and the cached check's (ctbl, oktbl, idx, r,
        s, k, s_ok) of n rows, the battery repeated."""
        rows = [torch.from_numpy(np.resize(x, (n,) + x.shape[1:])).to(dev) for x in og_rows]
        idx = torch.from_numpy(np.resize(og_idx, n)).to(dev)
        return tuple(rows), og_tbl + (idx,) + tuple(rows[1:])

    og_plain_in, og_cached_in = og_in(SIGS)

    # the secp256k1 kernels: the battery's 16 rows, and the cached
    # kernel's over a table of its keys in reverse order
    secp_edge = smoke.secp_edge_entries()
    secp_items = secp_edge + [secp_edge[0]] * 2
    secp_rows = list(sv.prepare_rows(secp_items, 16))
    for a, w in zip(secp_rows, smoke.secp_wrap_rows()):
        a[len(secp_edge):len(secp_edge) + 2] = w
    secp_pubs = sorted({p for p, _, _ in secp_edge})[::-1]
    secp_tbl = tuple(torch.from_numpy(a).to(dev) for a in sv.table_columns(secp_pubs))
    secp_crows = sv.prepare_rows_cached(
        secp_edge, np.array([secp_pubs.index(p) for p, _, _ in secp_edge], dtype=np.int32), 16,
        len(secp_pubs), len(secp_pubs))

    def secp_in(n):
        """The uncached and the cached kernel's arguments at n rows, the
        16 repeated, row 16 (n // 32) (an accepted one) with a wrong r."""
        bad = 16 * (n // 32)

        def grow(arrays, r_at):
            out = [np.resize(x, (n,) + x.shape[1:]) for x in arrays]
            for j in r_at:
                out[j][bad, 0] ^= 1
            return [torch.from_numpy(x).to(dev) for x in out]

        return tuple(grow(secp_rows, (4, 5))), secp_tbl + tuple(grow(secp_crows, (3, 4)))

    secp_plain_in, secp_cached_in = secp_in(SIGS)

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
        "og_verify": lambda: og.og_verify(*og_plain_in),
        "og_verify_cached": lambda: og.og_verify_cached(*og_cached_in),
        "secp_verify": lambda: sv.secp_verify(*secp_plain_in),
        "secp_verify_cached": lambda: sv.secp_verify_cached(*secp_cached_in),
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
        "og_verify": lambda: og.og_verify_plain(*og_plain_in),
        "og_verify_cached": lambda: og.og_verify_cached_plain(*og_cached_in),
        "secp_verify": lambda: sv.verify_plain(*secp_plain_in, want_xyz=True),
        "secp_verify_cached": lambda: sv.verify_cached_plain(*secp_cached_in, want_xyz=True),
    }
    with_xyz = {
        "secp_verify": lambda: sv.secp_verify(*secp_plain_in, want_xyz=True),
        "secp_verify_cached": lambda: sv.secp_verify_cached(*secp_cached_in, want_xyz=True),
    }
    if args.only:
        only = args.only.split(",")
        runs = {k: v for k, v in runs.items() if k in only}
    equal = {k: same(with_xyz.get(k, runs[k])(), fn()) for k, fn in plain.items() if k in runs}
    accepts = {k: [int(runs[k]().sum().item()), SIGS]
               for k in ("og_verify", "og_verify_cached", "secp_verify", "secp_verify_cached")
               if k in runs}

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
            plain_in, cached_in = og_in(n)
            runs[f"og_verify@{n}"] = (lambda a: lambda: og.og_verify(*a))(plain_in)
            runs[f"og_verify_cached@{n}"] = (
                lambda a: lambda: og.og_verify_cached(*a))(cached_in)
            plain_in, cached_in = secp_in(n)
            runs[f"secp_verify@{n}"] = (lambda a: lambda: sv.secp_verify(*a))(plain_in)
            runs[f"secp_verify_cached@{n}"] = (
                lambda a: lambda: sv.secp_verify_cached(*a))(cached_in)
    if args.only:
        runs = {k: v for k, v in runs.items() if k.split("@")[0] in only}
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
        "accepts": accepts,
        "ptxas": {k: v for k, v in smoke.kernel_resources(build.ptxas).items() if k in TIMED},
        "sass": _sass(build.path),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
