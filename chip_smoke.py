#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order:

1. the card: `nvidia-smi` name and power limit, torch's device name;
2. build: the CUDA kernels of tendermint_tpu_torch/csrc, with the build
   seconds and each kernel's registers and spills (`-Xptxas -v`);
3. kernels: K1, K2 and K3 of the RLC path, each on the card against its
   plain PyTorch version on the card, at 64 and at 2,560 lanes, over the
   ZIP-215 edge battery, padding lanes and one tampered lane. Coordinates
   are compared after canonicalisation, flags, digits and verdicts
   exactly;
4. slice: `types.validation.verify_commit` on a 10,000-validator ed25519
   commit on the card: the valid commit passes, a tampered signature
   raises `wrong signature (#i): <HEX>`, and a commit below 2/3 of the
   voting power raises ErrNotEnoughVotingPowerSigned. The three kernels'
   launch counters are set to 0 just before the valid run and read just
   after it;
5. timing: the end-to-end verify_commit wall clock (warm, median); a
   torch.profiler trace of a few more calls, from which each call's host
   stages (the port's record_function spans), the rest of the call, and
   the card's busy time and idle share come; each kernel's time from
   CUDA events beside its plain version's time and its bound; and peak
   device memory. The trace is kept in build/traces/.

It prints one JSON line of kernel records, then the `nvidia-smi` line,
then, last, `{"ok": true, "device": {...}}`. Any failed check exits
non-zero without that last line, as does a machine without a CUDA card
or a directory without the package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tendermint_tpu_torch.crypto import _edwards
from tendermint_tpu_torch.crypto import ed25519
from tendermint_tpu_torch.ops import fe, kernels, rlc
from tendermint_tpu_torch.ops.entry_block import EntryBlock
from tendermint_tpu_torch.types import validation
from tendermint_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    Commit,
    CommitSig,
    PartSetHeader,
)
from tendermint_tpu_torch.types.validator_set import (
    ErrNotEnoughVotingPowerSigned,
    Validator,
    ValidatorSet,
)
from tendermint_tpu_torch.wire import canonical

SEED = 1016
N_VALIDATORS = 10_000
CHAIN_ID = "chip-smoke"
HEIGHT = 7
ROUND = 0
T0_SECONDS = 1_760_000_000
BLOCK = BlockID(
    hash=hashlib.sha256(b"chip-smoke block").digest(),
    part_set_header=PartSetHeader(1, hashlib.sha256(b"chip-smoke parts").digest()),
)
TAMPER_AT = 4321  # signature flipped in the tampered commit
LANE_SHAPES = (64, 2560)  # kernel-phase shapes; 2,560 lanes = 10,240 signatures
REPEATS = 20  # warm end-to-end runs (median)
PROFILED = 5  # verify_commit calls traced by torch.profiler for the stages
KERNEL_REPS = 10  # launches per CUDA-event timing
TRACE_PATH = kernels.BUILD_DIR.parent / "traces" / "verify_commit.json"
# the port's record_function spans on the batch path, in path order
HOST_STAGES = ("commit.select", "commit.sign_bytes", "rlc.prep", "rlc.h2d",
               "rlc.kernels", "rlc.d2h", "rlc.expand")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# Bound model of one H100 (SXM, 700 W): 132 SMs, each 64 INT32 lanes a
# clock at the SM clock nvidia-smi reports as its maximum, and HBM3 at
# 3.35 TB/s. The work is the 32-bit multiply-adds of the limb
# convolutions: 400 for a field multiply, 210 for a squaring.
SMS = 132
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
PRODUCTS_MUL = 400
PRODUCTS_SQ = 210
# multiply-adds per lane, as csrc/rlc.cu's header states them
PRODUCTS_PER_LANE = {"k1_rlc": 492_400, "k2_rlc": 203_520, "k3_rlc": 1_956_000}

SOURCE = "tendermint_tpu_torch/csrc/rlc.cu"
REPLACES = {
    "k1_rlc": "tendermint_tpu/ops/pallas_rlc.py:110",
    "k2_rlc": "tendermint_tpu/ops/pallas_rlc.py:177",
    "k3_rlc": "tendermint_tpu/ops/pallas_rlc.py:251",
}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# -- data ----------------------------------------------------------------------


def _vote_template() -> tuple:
    return canonical.canonical_vote_template(
        chain_id=CHAIN_ID,
        msg_type=canonical.SIGNED_MSG_TYPE_PRECOMMIT,
        height=HEIGHT,
        round_=ROUND,
        block_id=BLOCK.canonical(),
    )


def _sign_validator(i: int) -> tuple:
    """(pub, timestamp, sig) of validator i's precommit for BLOCK. Each
    validator's timestamp depends only on i, so signing needs no pass over
    the sorted set first."""
    seed = hashlib.sha256(b"chip-smoke validator %d %d" % (SEED, i)).digest()
    ts = canonical.Timestamp(T0_SECONDS, 1000 * i + 1)
    msg = canonical.compose_vote_sign_bytes(_vote_template(), ts)
    return _edwards.pubkey_from_seed(seed), ts, _edwards.sign(seed, msg)


def _oracle(entry: tuple) -> bool:
    return _edwards.verify_zip215(*entry)


def build_commit(pool) -> tuple:
    """(ValidatorSet, Commit) of N_VALIDATORS validators, all signing."""
    signed = pool.map(_sign_validator, range(N_VALIDATORS), chunksize=64)
    powers = np.random.default_rng(SEED).integers(1, 1000, N_VALIDATORS)
    vals = ValidatorSet.new([
        Validator.new(ed25519.PubKey(pub), int(p))
        for (pub, _, _), p in zip(signed, powers)
    ])
    by_pub = {pub: (ts, sig) for pub, ts, sig in signed}
    sigs = []
    for v in vals.validators:
        ts, sig = by_pub[v.pub_key.bytes()]
        sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts, sig))
    return vals, Commit(HEIGHT, ROUND, BLOCK, sigs)


def commit_entries(commit: Commit, vals: ValidatorSet) -> list:
    return [
        (v.pub_key.bytes(), commit.vote_sign_bytes(CHAIN_ID, i), cs.signature)
        for i, (v, cs) in enumerate(zip(vals.validators, commit.signatures))
    ]


def tamper(sig: bytes) -> bytes:
    b = bytearray(sig)
    b[40] ^= 0x10  # inside s: still below L, the equation fails
    return bytes(b)


def edge_entries() -> list:
    """Entries over every ZIP-215 accept and reject branch: valid
    signatures, a corrupted signature, a wrong message, a corrupted key,
    s >= L, small-order keys (accepted for any message), non-canonical
    key encodings (accepted), and random bytes."""
    rng = random.Random(SEED)
    out = []
    for i in range(6):
        sk = ed25519.gen_priv_key(bytes([i + 1]) * 32)
        msg = b"edge-%d" % i
        out.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    sk = ed25519.gen_priv_key(bytes(32))
    msg, pub = b"hello", sk.pub_key().bytes()
    sig = sk.sign(msg)
    out.append((pub, msg, tamper(sig)))
    out.append((pub, b"other", sig))
    bad_pub = bytearray(pub)
    bad_pub[3] ^= 1
    out.append((bytes(bad_pub), msg, sig))
    out.append((pub, msg, sig[:32] + (_edwards.L + 5).to_bytes(32, "little")))
    small = []
    for y in range(50):
        for sign in (0, 1):
            enc = bytearray(y.to_bytes(32, "little"))
            enc[31] |= sign << 7
            pt = _edwards.decompress(bytes(enc))
            if pt is not None and _edwards.is_identity(_edwards.mult_by_cofactor(pt)):
                small.append(bytes(enc))
    check(len(small) > 0, "no small-order encodings found")
    for enc in small[:3]:
        s = rng.randrange(0, _edwards.L)
        r = _edwards.compress(_edwards.scalar_mult(s, _edwards.BASE))
        out.append((enc, b"anything", r + s.to_bytes(32, "little")))
    for enc in small:
        y = int.from_bytes(enc, "little") & ((1 << 255) - 1)
        if y < 19:
            enc2 = ((y + _edwards.P) | ((enc[31] >> 7) << 255)).to_bytes(32, "little")
            s = rng.randrange(0, _edwards.L)
            r = _edwards.compress(_edwards.scalar_mult(s, _edwards.BASE))
            out.append((enc2, b"nc", r + s.to_bytes(32, "little")))
    for _ in range(3):
        out.append((rng.randbytes(32), rng.randbytes(20), rng.randbytes(64)))
    return out


# -- build ---------------------------------------------------------------------


def build_kernels() -> None:
    b = kernels.build()
    log(f"build: {b.seconds:.2f} s ({b.path.name})")
    for line in b.ptxas.splitlines():
        if any(k in line for k in ("entry function", "Function properties", "registers", "spill")):
            log("  ptxas: " + line.strip())
    kernels.library()


# -- kernel phase --------------------------------------------------------------


def _canon_slots(x: torch.Tensor) -> torch.Tensor:
    """(slots*32, g) coordinate slots -> their canonical limbs."""
    slots, g = x.shape[0] // 32, x.shape[1]
    limbs = x.view(slots, 32, g)[:, : fe.NLIMBS].permute(1, 0, 2).reshape(fe.NLIMBS, slots * g)
    return fe.canon(limbs)


def _max_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def kernel_phase(entries_by_lanes: dict, expected_lanes: dict, dev) -> dict:
    """K1-K3 against their plain versions on the card. Returns per kernel
    the max abs error over both shapes and the plain time at the last."""
    stats = {k: {"max_abs_err": 0, "plain_ms": None} for k in REPLACES}
    for lanes, block in entries_by_lanes.items():
        args = rlc.prepare_rlc(block, lanes * rlc.M)
        a_t, r_t, scal_t, sok = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args)
        check(a_t.shape[-1] == lanes, f"prepared {a_t.shape[-1]} lanes, wanted {lanes}")

        (coords_p, ok_p, dig_p), ms1 = _timed(lambda: rlc.k1_rlc_plain(a_t, r_t, scal_t))
        coords_k, ok_k, dig_k = rlc.k1_rlc(a_t, r_t, scal_t)
        torch.cuda.synchronize()
        err1 = _max_err(_canon_slots(coords_k), _canon_slots(coords_p))
        check(err1 == 0, f"K1 coords differ at {lanes} lanes (max {err1})")
        check(torch.equal(ok_k, ok_p), f"K1 flags differ at {lanes} lanes")
        check(torch.equal(dig_k, dig_p), f"K1 digits differ at {lanes} lanes")
        raw1 = torch.equal(coords_k, coords_p)

        tbl_p, ms2 = _timed(lambda: rlc.k2_rlc_plain(coords_p))
        tbl_k = rlc.k2_rlc(coords_p)
        torch.cuda.synchronize()
        err2 = _max_err(_canon_slots(tbl_k), _canon_slots(tbl_p))
        check(err2 == 0, f"K2 table differs at {lanes} lanes (max {err2})")
        raw2 = torch.equal(tbl_k, tbl_p)

        out_p, ms3 = _timed(lambda: rlc.k3_rlc_plain(tbl_p, dig_p, coords_p, ok_p, sok))
        out_k = rlc.k3_rlc(tbl_p, dig_p, coords_p, ok_p, sok)
        torch.cuda.synchronize()
        err3 = _max_err(out_k, out_p)
        check(err3 == 0, f"K3 verdicts differ at {lanes} lanes")

        got = out_k.cpu().numpy()[0].astype(bool)
        want = expected_lanes[lanes]
        check(bool((got == want).all()),
              f"lane verdicts at {lanes} lanes differ from the oracle at "
              f"{np.nonzero(got != want)[0][:8].tolist()}")
        log(f"kernels @ {lanes} lanes: K1 K2 K3 equal to plain (raw limbs equal: "
            f"K1 {raw1}, K2 {raw2}); {int((~got).sum())} lanes reject; "
            f"plain ms K1 {ms1:.1f} K2 {ms2:.1f} K3 {ms3:.1f}")
        for name, err, ms in (("k1_rlc", err1, ms1), ("k2_rlc", err2, ms2), ("k3_rlc", err3, ms3)):
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            stats[name]["plain_ms"] = ms
    return stats


def lane_inputs(commit_ents: list, edge: list, lanes: int, pool) -> tuple:
    """An EntryBlock for `lanes` RLC lanes: the edge battery, commit
    signatures with one tampered, a last lane holding one signature and
    three padding slots, and at least 8 padding lanes; and the oracle's
    lane verdicts for it (a lane accepts iff all its signatures do;
    padding accepts)."""
    n = min(lanes * rlc.M - 8 * rlc.M, len(edge) + len(commit_ents)) - 3
    body = list(commit_ents[: n - len(edge)])
    pk, msg, sig = body[len(body) // 2]
    body[len(body) // 2] = (pk, msg, tamper(sig))
    ents = edge + body
    # commit signatures are valid except the tampered one
    per_sig = np.ones(len(ents), dtype=bool)
    per_sig[: len(edge)] = pool.map(_oracle, edge)
    per_sig[len(edge) + len(body) // 2] = False
    padded = np.ones(lanes * rlc.M, dtype=bool)
    padded[: len(ents)] = per_sig
    return EntryBlock.from_entries(ents), padded.reshape(lanes, rlc.M).all(axis=1)


# -- slice phase ---------------------------------------------------------------


def expect_error(fn, exc_type, message: str) -> None:
    try:
        fn()
    except exc_type as e:
        check(str(e) == message, f"wrong error: {e!s:.120} (wanted {message:.120})")
        return
    raise SmokeFailure(f"no {exc_type.__name__} raised (wanted {message:.80})")


def slice_phase(vals, commit, dev) -> dict:
    """verify_commit on the card; returns the launch counts of the valid run."""
    rlc.reset_launches()
    validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, commit, device=dev)
    launches = dict(rlc.LAUNCHES)
    log(f"slice: valid {N_VALIDATORS}-validator commit verified; launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by verify_commit")

    bad = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    cs = bad.signatures[TAMPER_AT]
    bad.signatures[TAMPER_AT] = dataclasses.replace(cs, signature=tamper(cs.signature))
    expect_error(
        lambda: validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, bad, device=dev),
        ValueError,
        f"wrong signature (#{TAMPER_AT}): {bad.signatures[TAMPER_AT].signature.hex().upper()}",
    )
    log(f"slice: tampered signature #{TAMPER_AT} blamed")

    total = vals.total_voting_power()
    needed = total * 2 // 3
    low = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    got = total
    for i, v in enumerate(vals.validators):
        if got <= needed:
            break
        low.signatures[i] = CommitSig(BLOCK_ID_FLAG_ABSENT)
        got -= v.voting_power
    expect_error(
        lambda: validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, low, device=dev),
        ErrNotEnoughVotingPowerSigned,
        f"invalid commit -- insufficient voting power: got {got}, needed more than {needed}",
    )
    log(f"slice: low power ({got} of {total}) rejected")
    return launches


# -- timing --------------------------------------------------------------------


def count_products(a_t, r_t, scal_t, sok) -> dict:
    """Multiply-adds per lane of each kernel, counted by running the plain
    versions on one lane on the CPU with fe.mul and fe.sq counted per
    column (the kernels run the same formulas; a squaring is counted at
    the kernel's 210 products). Each count must equal the one stated in
    csrc/rlc.cu's header: a field product the count misses would
    otherwise lower the bound without an error."""
    one = [t[:, :1].cpu().contiguous() for t in (a_t, r_t, scal_t, sok)]
    counts = {"mul": 0, "sq": 0}
    real_mul, real_sq = fe.mul, fe.sq

    def mul(a, b):
        # a curve constant is one (20, 1) column broadcast over the batch
        counts["mul"] += max(a.shape[-1], b.shape[-1])
        return real_mul(a, b)

    def sq(a):
        counts["sq"] += a.shape[-1]
        return real_sq(a)

    def products(fn):
        counts["mul"] = counts["sq"] = 0
        out = fn()
        return out, counts["mul"] * PRODUCTS_MUL + counts["sq"] * PRODUCTS_SQ

    fe.mul, fe.sq = mul, sq
    try:
        (coords, ok, dig), p1 = products(lambda: rlc.k1_rlc_plain(*one[:3]))
        tbl, p2 = products(lambda: rlc.k2_rlc_plain(coords))
        _, p3 = products(lambda: rlc.k3_rlc_plain(tbl, dig, coords, ok, one[3]))
    finally:
        fe.mul, fe.sq = real_mul, real_sq
    counted = {"k1_rlc": p1, "k2_rlc": p2, "k3_rlc": p3}
    check(counted == PRODUCTS_PER_LANE,
          f"multiply-adds per lane {counted}, csrc/rlc.cu states {PRODUCTS_PER_LANE}")
    return counted


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _union_ms(intervals: list) -> float:
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def profiled_calls(vals, commit, dev) -> list:
    """PROFILED verify_commit calls under torch.profiler. From the one
    trace, per call: its wall time, each host stage span (the port's
    record_function spans), the rest of the call outside them, and the
    union of the card's kernel and copy intervals inside the call."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED):
            with torch.profiler.record_function("verify_commit"):
                validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, commit, device=dev)
        torch.cuda.synchronize()
    TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_PATH))
    with open(TRACE_PATH) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    calls = sorted((e for e in spans if e["name"] == "verify_commit"), key=lambda e: e["ts"])
    check(len(calls) == PROFILED, f"trace holds {len(calls)} verify_commit spans, wanted {PROFILED}")
    out = []
    for c in calls:
        t0, t1 = c["ts"], c["ts"] + c["dur"]

        def inside(e):
            return t0 <= e["ts"] and e["ts"] + e["dur"] <= t1

        mine = [e for e in spans if inside(e)]
        missing = set(HOST_STAGES) - {e["name"] for e in mine}
        check(not missing, f"a traced verify_commit call lacks the spans {sorted(missing)}")
        stages = {s: sum(e["dur"] for e in mine if e["name"] == s) / 1e3 for s in HOST_STAGES}
        stages["rest"] = c["dur"] / 1e3 - sum(stages.values())
        dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
        out.append({
            "call_ms": c["dur"] / 1e3,
            "stages_ms": stages,
            "device_events": {k: sum(e.get("cat") == k for e in dev_ev) for k in DEVICE_CATS},
            "device_busy_ms": _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in dev_ev]),
        })
    return out


def timing_phase(vals, commit, block, dev, sm_clock_hz: float) -> tuple:
    """End-to-end times, the stage breakdown of profiled calls, and each
    kernel's CUDA-event time beside its bound; returns (kernel records,
    summary)."""
    torch.cuda.reset_peak_memory_stats(dev)
    e2e = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, commit, device=dev)
        e2e.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated(dev)
    e2e_ms = statistics.median(e2e) * 1e3

    prof = profiled_calls(vals, commit, dev)
    stage_ms = {k: statistics.median(p["stages_ms"][k] for p in prof) for k in prof[0]["stages_ms"]}
    prof_ms = statistics.median(p["call_ms"] for p in prof)
    n_dev = sum(sum(p["device_events"].values()) for p in prof)
    if n_dev:
        busy_ms = statistics.median(p["device_busy_ms"] for p in prof)
        idle = statistics.median(1 - p["device_busy_ms"] / p["call_ms"] for p in prof)
        log(f"timing: profiled calls: device busy {busy_ms:.3f} ms (median), idle "
            f"{idle:.1%} of the call; device events per call "
            f"{prof[0]['device_events']}")
    else:
        busy_ms = idle = None
        log("timing: the profiler trace holds no device events: device busy and "
            "idle share not measured")

    bucket, g = rlc.plan_bucket(len(block))
    args = rlc.prepare_rlc(block, bucket)
    a_t, r_t, scal_t, sok = (torch.from_numpy(a).to(dev) for a in args)
    coords, ok, dig = rlc.k1_rlc(a_t, r_t, scal_t)
    tbl = rlc.k2_rlc(coords)
    out = rlc.k3_rlc(tbl, dig, coords, ok, sok)
    check(bool(out.all().item()), "the commit's lanes did not all accept")
    k_ms = {
        "k1_rlc": event_ms(lambda: rlc.k1_rlc(a_t, r_t, scal_t), KERNEL_REPS),
        "k2_rlc": event_ms(lambda: rlc.k2_rlc(coords), KERNEL_REPS),
        "k3_rlc": event_ms(lambda: rlc.k3_rlc(tbl, dig, coords, ok, sok), KERNEL_REPS),
    }
    products = count_products(a_t, r_t, scal_t, sok)
    io_bytes = {
        "k1_rlc": sum(t.nbytes for t in (a_t, r_t, scal_t, coords, ok, dig)),
        "k2_rlc": coords.nbytes + tbl.nbytes,
        "k3_rlc": sum(t.nbytes for t in (tbl, dig, coords, ok, sok, out)),
    }
    int_rate = SMS * INT32_LANES_PER_SM * sm_clock_hz
    records = []
    for name in REPLACES:
        ops_ms = products[name] * g / int_rate * 1e3
        bytes_ms = io_bytes[name] / HBM_BYTES_PER_S * 1e3
        records.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "ms": k_ms[name],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "products_per_lane": products[name],
            "bytes": io_bytes[name],
        })
        log(f"timing: {name} {k_ms[name]:.3f} ms at {g} lanes; bound "
            f"{max(ops_ms, bytes_ms):.4f} ms ({products[name] * g / 1e9:.3f} G "
            f"multiply-adds -> {ops_ms:.4f} ms, {io_bytes[name] / 1e6:.2f} MB -> "
            f"{bytes_ms:.4f} ms)")
    summary = {
        "verify_commit_ms": e2e_ms,
        "verify_commit_runs_ms": [x * 1e3 for x in e2e],
        "sigs_per_s": N_VALIDATORS / (e2e_ms / 1e3),
        "profiled_call_ms": prof_ms,
        "profiled_calls": prof,
        "stages_ms": stage_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": idle,
        "max_memory_allocated": peak,
        "lanes": g,
    }
    log(f"timing: verify_commit {N_VALIDATORS} validators median {e2e_ms:.2f} ms "
        f"over {REPEATS} warm runs (min {min(e2e) * 1e3:.2f}, max {max(e2e) * 1e3:.2f}; "
        f"{summary['sigs_per_s']:.0f} sigs/s)")
    log(f"timing: {PROFILED} profiled calls, median {prof_ms:.2f} ms; stages (median ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms.items()))
    log(f"timing: max_memory_allocated {peak} bytes")
    return records, summary


# -- main ----------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    clocks = nvidia_smi("clocks.sm,clocks.max.sm")
    sm_clock_hz = float(clocks.split(",")[1].strip().split()[0]) * 1e6
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
        f"sm clock now, max: {clocks}")

    t = time.perf_counter()
    build_kernels()
    log(f"build phase: {time.perf_counter() - t:.1f} s")

    ctx = multiprocessing.get_context("spawn")
    # the cores this process may run on, not the host's count
    workers = min(16, len(os.sched_getaffinity(0)))
    with ctx.Pool(workers) as pool:
        t = time.perf_counter()
        vals, commit = build_commit(pool)
        log(f"data: {N_VALIDATORS}-validator commit signed in "
            f"{time.perf_counter() - t:.1f} s by {workers} processes")
        ents = commit_entries(commit, vals)
        edge = edge_entries()
        inputs = {}
        expected = {}
        for lanes in LANE_SHAPES:
            inputs[lanes], expected[lanes] = lane_inputs(ents, edge, lanes, pool)

    t = time.perf_counter()
    kstats = kernel_phase(inputs, expected, dev)
    log(f"kernel phase: {time.perf_counter() - t:.1f} s")

    launches = slice_phase(vals, commit, dev)

    records, summary = timing_phase(vals, commit, EntryBlock.from_entries(ents),
                                    dev, sm_clock_hz)
    for r in records:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = kstats[r["name"]]["max_abs_err"]
        r["plain_ms"] = kstats[r["name"]]["plain_ms"]
    log("summary: " + json.dumps(summary))
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
