#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order:

1. the card: `nvidia-smi` name and power limit, torch's device name;
2. build: the CUDA kernels of tendermint_tpu_torch/csrc, one nvcc per
   source, all started together, with the build seconds and each
   kernel's registers, stack frame and spills (`-Xptxas -v`, also in its
   kernel record when this run built the library); and the host library
   (csrc/merlin.cpp, the sr25519 challenges) with the host C++ compiler;
3. kernels: each of the eleven CUDA entries on the card against its plain
   PyTorch version on the card: the RLC K1, cached K1, K2 and K3 at 64
   and 2,560 lanes; the per-signature K1, cached K1, K2 and K3 at 256 and
   10,240 signatures; the sr25519 K1r, K2 and K3r at 64 and 10,240
   signatures; and the epoch table build at 16,384 rows; over the
   ZIP-215 and ristretto edge batteries, padding and one tampered
   signature. Coordinates are compared after canonicalisation (the raw
   limbs of k2_table's table and k1_decompress_cached's coordinates,
   rows 20..31 of each slot included), flags, digits and verdicts
   exactly, and the verdicts against the oracles;
4. slice: `types.validation.verify_commit` on a 10,000-validator commit
   on the card, on each path with the launch counters set to 0 just
   before it and read just after:
   (a) RLC, ed25519: five calls on one validator set, the first cold
       (k1_rlc), the rest warm (k1_rlc_cached, the epoch table built
       once), with the epoch cache's misses and hits; a tampered
       signature raises `wrong signature (#i): <HEX>` warm and cold;
       verify_commit_light runs warm; a commit below 2/3 raises
       ErrNotEnoughVotingPowerSigned;
   (b) per-signature (TM_TPU_RLC=0), epoch cache off: the valid,
       tampered and below-2/3 commits give the same results, through
       k1_decompress, k2_table and k3_ladder once each per call;
   (c) per-signature warm (TM_TPU_RLC=0, epoch cache on): three calls on
       one set, the first through k1_decompress, the others through
       k1_decompress_cached; the tampered commit is blamed warm;
   (d) sr25519: a 10,000-validator sr25519 commit through k1r_decode,
       k2_table and k3r_ladder once each per call: valid, tampered and
       below 2/3, never noted in the epoch cache;
5. timing, for each path (RLC cold, RLC warm, per-signature,
   per-signature warm, sr25519): the end-to-end verify_commit wall clock
   (warm, median of 20); a torch.profiler trace of 5 more calls, from
   which each call's host stages (the port's record_function spans), the
   rest of the call, and the card's busy time and idle share come; peak
   device memory. Then each kernel's time from CUDA events at the path's
   shape beside its plain version's time, its bound and the share of the
   bound it reaches (`pct_of_bound`). The traces are kept in
   build/traces/.

It prints one JSON line of kernel records, then the `nvidia-smi` line,
then, last, `{"ok": true, "device": {...}}`. Any failed check exits
non-zero without that last line, as does a machine without a CUDA card
or a directory without the package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import multiprocessing
import os
import random
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tendermint_tpu_torch.crypto import _edwards, _ristretto
from tendermint_tpu_torch.crypto import ed25519, sr25519
from tendermint_tpu_torch.ops import epoch_cache, fe, host, kernels, rlc, verify
from tendermint_tpu_torch.ops import sr25519 as osr
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
LANE_SHAPES = (64, 2560)  # RLC kernel shapes; 2,560 lanes = 10,240 signatures
SR_SHAPES = (64, 10240)  # sr25519 kernel shapes, in signatures
WARM_CALLS = 5  # verify_commit calls on one set in slice (a): 1 cold, 4 warm
REPEATS = 20  # warm end-to-end runs (median)
PROFILED = 5  # verify_commit calls traced by torch.profiler for the stages
KERNEL_REPS = 10  # launches per CUDA-event timing
TRACE_DIR = kernels.BUILD_DIR.parent / "traces"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's record_function spans on each batch path, in path order
COMMIT_STAGES = ("commit.select", "commit.sign_bytes")
PATHS = {
    "rlc_cold": COMMIT_STAGES + ("rlc.prep", "rlc.h2d", "rlc.kernels", "rlc.d2h",
                                 "rlc.expand"),
    "rlc_warm": COMMIT_STAGES + ("rlc.prep", "rlc.gather", "rlc.h2d", "rlc.kernels",
                                 "rlc.d2h", "rlc.expand"),
    "per_signature": COMMIT_STAGES + ("verify.prep", "verify.h2d", "verify.kernels",
                                      "verify.d2h"),
    "per_signature_warm": COMMIT_STAGES + ("verify.prep", "verify.gather", "verify.h2d",
                                           "verify.kernels", "verify.d2h"),
    "sr25519": COMMIT_STAGES + ("sr.prep", "sr.h2d", "sr.kernels", "sr.d2h"),
}
# each path: (TM_TPU_RLC, epoch cache depth, the commit's key type)
PATH_SETUP = {
    "rlc_cold": (None, 0, "ed25519"),
    "rlc_warm": (None, epoch_cache.DEFAULT_DEPTH, "ed25519"),
    "per_signature": ("0", 0, "ed25519"),
    "per_signature_warm": ("0", epoch_cache.DEFAULT_DEPTH, "ed25519"),
    "sr25519": (None, epoch_cache.DEFAULT_DEPTH, "sr25519"),
}

# Bound model of one H100 (SXM, 700 W): 132 SMs, each 64 INT32 lanes a
# clock at the SM clock nvidia-smi reports as its maximum, and HBM3 at
# 3.35 TB/s. The work is the 32-bit multiply-adds of the limb
# convolutions: 400 for a field multiply, 210 for a squaring.
SMS = 132
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
PRODUCTS_MUL = 400
PRODUCTS_SQ = 210
# multiply-adds per unit of work (an RLC lane, a table row, a signature),
# as the headers of csrc/rlc.cu, csrc/verify.cu and csrc/sr25519.cu state them
PRODUCTS_PER_UNIT = {
    "k1_rlc": 492_400, "k1_rlc_cached": 246_200, "k2_rlc": 203_520,
    "k3_rlc": 1_956_000, "epoch_coords": 61_550,
    "k1_decompress": 123_100, "k1_decompress_cached": 61_550, "k2_table": 50_880,
    "k3_ladder": 938_400, "k1r_decode": 128_740, "k3r_ladder": 926_160,
}
KERNELS = {  # name: (source, the TPU kernel or XLA function it replaces)
    "k1_rlc": ("rlc.cu", "tendermint_tpu/ops/pallas_rlc.py:110"),
    "k1_rlc_cached": ("rlc.cu", "tendermint_tpu/ops/pallas_rlc.py:139"),
    "k2_rlc": ("rlc.cu", "tendermint_tpu/ops/pallas_rlc.py:177"),
    "k3_rlc": ("rlc.cu", "tendermint_tpu/ops/pallas_rlc.py:251"),
    "epoch_coords": ("rlc.cu", "tendermint_tpu/ops/epoch_cache.py:292"),
    "k1_decompress": ("verify.cu", "tendermint_tpu/ops/pallas_verify.py:239"),
    "k1_decompress_cached": ("verify.cu", "tendermint_tpu/ops/pallas_verify.py:263"),
    "k2_table": ("verify.cu", "tendermint_tpu/ops/pallas_verify.py:286"),
    "k3_ladder": ("verify.cu", "tendermint_tpu/ops/pallas_verify.py:329"),
    "k1r_decode": ("sr25519.cu", "tendermint_tpu/ops/pallas_sr25519.py:75"),
    "k3r_ladder": ("sr25519.cu", "tendermint_tpu/ops/pallas_sr25519.py:98"),
}
# outputs of each kernel that hold 32-row coordinate slots compared after
# canonicalisation; the rest, and every output of k2_table and
# k1_decompress_cached, raw
SLOT_OUTPUTS = {"k1_rlc": (0,), "k1_rlc_cached": (0,), "k2_rlc": (0,), "k3_rlc": (),
                "epoch_coords": (0,), "k1_decompress": (0,), "k1_decompress_cached": (),
                "k2_table": (), "k3_ladder": (), "k1r_decode": (0,), "k3r_ladder": ()}


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


@contextlib.contextmanager
def rlc_env(value):
    """TM_TPU_RLC set to `value` (None: unset) inside the block."""
    old = os.environ.get("TM_TPU_RLC")
    if value is None:
        os.environ.pop("TM_TPU_RLC", None)
    else:
        os.environ["TM_TPU_RLC"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TM_TPU_RLC", None)
        else:
            os.environ["TM_TPU_RLC"] = old


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


def _sign_sr_validator(i: int) -> tuple:
    """_sign_validator with an sr25519 key."""
    sk = sr25519.PrivKey(hashlib.sha256(b"chip-smoke sr validator %d %d" % (SEED, i)).digest())
    ts = canonical.Timestamp(T0_SECONDS, 1000 * i + 1)
    msg = canonical.compose_vote_sign_bytes(_vote_template(), ts)
    return sk.pub_key().bytes(), ts, sk.sign(msg)


def _oracle(entry: tuple) -> bool:
    return _edwards.verify_zip215(*entry)


def _sr_oracle(entry: tuple) -> bool:
    return sr25519.verify(*entry)


def build_commit(pool, key_type: str = "ed25519") -> tuple:
    """(ValidatorSet, Commit) of N_VALIDATORS validators of one key type,
    all signing."""
    sign, key_cls = {"ed25519": (_sign_validator, ed25519.PubKey),
                     "sr25519": (_sign_sr_validator, sr25519.PubKey)}[key_type]
    signed = pool.map(sign, range(N_VALIDATORS), chunksize=64)
    powers = np.random.default_rng(SEED).integers(1, 1000, N_VALIDATORS)
    vals = ValidatorSet.new([
        Validator.new(key_cls(pub), int(p))
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
    key encodings (accepted), a key off the curve, and random bytes."""
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
    out.append(((2).to_bytes(32, "little"), msg, sig))  # y = 2: no point
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


def sr_edge_entries() -> list:
    """sr25519 entries over every accept and reject branch: valid
    signatures; a tampered s, a wrong message, no v1 marker, s >= L; keys
    that are odd, at p + 1, with bit 255 set, with 1 + s^2 = 0, not
    square, or with an odd t; an R that does not decode; the all-zero
    identity key (accepted for any message when R = [s]B); random bytes."""
    rng = random.Random(SEED)
    out = []
    for i in range(4):
        sk = sr25519.gen_priv_key(bytes([i + 1]) * 32)
        msg = b"sr-edge-%d" % i
        out.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    pk, msg, sig = out[0]
    out.append((pk, msg, tamper(sig)))
    out.append((pk, b"other", sig))
    out.append((pk, msg, sig[:63] + bytes([sig[63] & 0x7F])))
    out.append((pk, msg, sig[:32] + (_edwards.L + 3 | 1 << 255).to_bytes(32, "little")))
    p = _edwards.P
    i = _ristretto.SQRT_M1 if _ristretto.SQRT_M1 % 2 == 0 else p - _ristretto.SQRT_M1
    # 1 + s^2 = 0 at s = sqrt(-1); s = 8 is not square; s = 2 has an odd t
    for bad in (1, p + 1, 2**255 + 2, i, 8, 2):
        out.append((bad.to_bytes(32, "little"), msg, sig))
    out.append((pk, msg, (8).to_bytes(32, "little") + sig[32:]))
    s = rng.randrange(0, _edwards.L)
    r = _ristretto.encode(_ristretto.scalar_mult(s, _ristretto.BASE))
    out.append((bytes(32), b"identity key", r + (s | 1 << 255).to_bytes(32, "little")))
    for _ in range(2):
        out.append((rng.randbytes(32), rng.randbytes(20), rng.randbytes(64)))
    return out


def sr_inputs(commit_ents: list, edge: list, n: int, pool) -> tuple:
    """An EntryBlock for n sr25519 signatures: the edge battery, commit
    signatures with one tampered, and 3 padding signatures; and the
    oracle's verdicts padded to n (padding accepts)."""
    body = list(commit_ents[: n - 3 - len(edge)])
    pk, msg, sig = body[len(body) // 2]
    body[len(body) // 2] = (pk, msg, tamper(sig))
    per_sig = np.ones(n, dtype=bool)
    per_sig[: len(edge)] = pool.map(_sr_oracle, edge)
    per_sig[len(edge) + len(body) // 2] = False
    return EntryBlock.from_entries(edge + body), per_sig


def sig_inputs(commit_ents: list, edge: list, lanes: int, pool) -> tuple:
    """An EntryBlock for `lanes` RLC lanes (lanes * M signatures): the
    edge battery, commit signatures with one tampered, a last lane
    holding one signature and three padding slots, and at least 8
    padding lanes; and the oracle's per-signature verdicts padded to
    lanes * M (padding accepts)."""
    n = min(lanes * rlc.M - 8 * rlc.M, len(edge) + len(commit_ents)) - 3
    body = list(commit_ents[: n - len(edge)])
    pk, msg, sig = body[len(body) // 2]
    body[len(body) // 2] = (pk, msg, tamper(sig))
    ents = edge + body
    # commit signatures are valid except the tampered one
    per_sig = np.ones(lanes * rlc.M, dtype=bool)
    per_sig[: len(edge)] = pool.map(_oracle, edge)
    per_sig[len(edge) + len(body) // 2] = False
    return EntryBlock.from_entries(ents), per_sig


def with_epoch(block: EntryBlock, seed: int) -> tuple:
    """(block with val_idx and a key, its EpochEntry): the block's keys in
    a shuffled table, so val_idx runs out of order."""
    n = len(block)
    order = np.random.default_rng(seed).permutation(n)
    ep = epoch_cache.EpochEntry(b"smoke %d" % seed, block.pub[order])
    val_idx = np.argsort(order).astype(np.int32)
    return EntryBlock(block.pub, block.sig, block.msgs, block.offsets,
                      val_idx=val_idx, epoch_key=ep.key), ep


# -- build ---------------------------------------------------------------------


def kernel_resources(ptxas: str) -> dict:
    """Per kernel of KERNELS, from nvcc's -Xptxas -v report: registers a
    thread, and the stack frame and spill bytes."""
    out, name = {}, None
    for line in ptxas.splitlines():
        if "Function properties for" in line:
            m = re.search(r"for _ZN3edw\d+(\w+?)_kernelE", line)
            name = m.group(1) if m and m.group(1) in KERNELS else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if name and m:
            out.setdefault(name, {}).update(stack_bytes=int(m.group(1)),
                                            spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    check(sorted(out) == sorted(KERNELS), f"ptxas reported on {sorted(out)}")
    return out


def build_kernels() -> dict:
    t = time.perf_counter()
    log(f"build: host library {host.build().name} in {time.perf_counter() - t:.2f} s")
    b = kernels.build()
    log(f"build: {b.seconds:.2f} s, {len(kernels.SOURCES)} sources in parallel "
        f"({b.path.name})")
    kernels.library()
    if not b.seconds:  # a library built before: its ptxas report is not this run's
        log("build: loaded an existing library; registers and stack frames not reported")
        return {}
    for line in b.ptxas.splitlines():
        if line.startswith("==") or any(
            k in line for k in ("Compiling entry", "registers", "spill")
        ):
            log("  ptxas: " + line.strip())
    res = kernel_resources(b.ptxas)
    log("build: registers and stack frame bytes per kernel: " + ", ".join(
        f"{k} {v['registers']}/{v['stack_bytes']}" for k, v in res.items()))
    return res


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


def hold(stats: dict, name: str, label: str, plain, kernel) -> tuple:
    """Run kernel `name` and its plain version on the same inputs; check
    every output equal (coordinate slots after canonicalisation). Returns
    the plain version's outputs, which feed the next kernel."""
    want, ms = _timed(plain)
    got = kernel()
    torch.cuda.synchronize()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    err, raw = 0, True
    for i, (g, w) in enumerate(zip(got, want)):
        if i in SLOT_OUTPUTS[name]:
            err = max(err, _max_err(_canon_slots(g), _canon_slots(w)))
        else:
            err = max(err, _max_err(g, w))
        raw = raw and torch.equal(g, w)
    check(err == 0, f"{name} differs from its plain version at {label} (max abs error {err})")
    st = stats[name]
    st["max_abs_err"] = max(st["max_abs_err"], err)
    st["plain_ms"] = ms
    log(f"kernels: {name} @ {label}: equal to plain (raw limbs equal: {raw}); "
        f"plain {ms:.1f} ms")
    return want if len(want) > 1 else want[0]


def _verdicts(out: torch.Tensor) -> np.ndarray:
    return out.cpu().numpy()[0].astype(bool)


def kernel_phase(inputs: dict, sr_in: dict, table_pub: np.ndarray, dev) -> dict:
    """Every kernel against its plain version on the card. Returns per
    kernel the max abs error over its shapes and the plain time at the
    last (the main path's) shape."""
    stats = {k: {"max_abs_err": 0, "plain_ms": None} for k in KERNELS}
    M = rlc.M
    for lanes in LANE_SHAPES:
        block, per_sig = inputs[lanes]
        want_lanes = per_sig.reshape(lanes, M).all(axis=1)
        label = f"{lanes} lanes"
        a_t, r_t, scal_t, sok = (
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in rlc.prepare_rlc(block, lanes * M)
        )
        check(a_t.shape[-1] == lanes, f"prepared {a_t.shape[-1]} lanes, wanted {lanes}")
        coords, ok, dig = hold(stats, "k1_rlc", label, lambda: rlc.k1_rlc_plain(a_t, r_t, scal_t),
                               lambda: rlc.k1_rlc(a_t, r_t, scal_t))
        tbl = hold(stats, "k2_rlc", label, lambda: rlc.k2_rlc_plain(coords),
                   lambda: rlc.k2_rlc(coords))
        out = hold(stats, "k3_rlc", label, lambda: rlc.k3_rlc_plain(tbl, dig, coords, ok, sok),
                   lambda: rlc.k3_rlc(tbl, dig, coords, ok, sok))
        got = _verdicts(out)
        check(bool((got == want_lanes).all()),
              f"cold lane verdicts at {label} differ from the oracle at "
              f"{np.nonzero(got != want_lanes)[0][:8].tolist()}")

        wblock, ep = with_epoch(block, lanes)
        idx, r_rows, scal_rows, sok_rows = rlc.prepare_rlc_cached(wblock, lanes * M, ep)
        pub_t = torch.from_numpy(np.ascontiguousarray(ep.pub_rows.T)).to(dev)
        ctbl, oktbl = epoch_cache.epoch_coords_plain(pub_t)
        idx, r_rows, scal_rows = (torch.from_numpy(a).to(dev) for a in (idx, r_rows, scal_rows))
        sok_w = torch.from_numpy(np.ascontiguousarray(sok_rows.T)).to(dev)
        coords, ok, dig = hold(
            stats, "k1_rlc_cached", label,
            lambda: rlc.k1_rlc_cached_plain(ctbl, oktbl, idx, r_rows, scal_rows),
            lambda: rlc.k1_rlc_cached(ctbl, oktbl, idx, r_rows, scal_rows))
        got = _verdicts(rlc.k3_rlc(rlc.k2_rlc(coords), dig, coords, ok, sok_w))
        check(bool((got == want_lanes).all()),
              f"warm lane verdicts at {label} differ from the oracle at "
              f"{np.nonzero(got != want_lanes)[0][:8].tolist()}")
        log(f"kernels: {label}: cold and warm lanes equal the oracle; "
            f"{int((~want_lanes).sum())} lanes reject")

        n = lanes * M
        label = f"{n} signatures"
        a_t, r_t, s_t, k_t, sok = (torch.from_numpy(a).to(dev)
                                   for a in verify.prepare_compact(block, n))
        coords, ok, sdig, kdig = hold(
            stats, "k1_decompress", label, lambda: verify.k1_decompress_plain(a_t, r_t, s_t, k_t),
            lambda: verify.k1_decompress(a_t, r_t, s_t, k_t))
        tbl = hold(stats, "k2_table", label, lambda: verify.k2_table_plain(coords),
                   lambda: verify.k2_table(coords))
        out = hold(stats, "k3_ladder", label,
                   lambda: verify.k3_ladder_plain(tbl, sdig, kdig, coords, ok, sok),
                   lambda: verify.k3_ladder(tbl, sdig, kdig, coords, ok, sok))
        got = _verdicts(out)
        check(bool((got == per_sig).all()),
              f"per-signature verdicts at {label} differ from the oracle at "
              f"{np.nonzero(got != per_sig)[0][:8].tolist()}")

        # the warm K1 over the RLC section's shuffled table
        warm_args = [torch.from_numpy(a).to(dev)
                     for a in verify.prepare_compact_cached(wblock, n, ep)]
        coords, ok, sdig, kdig = hold(
            stats, "k1_decompress_cached", label,
            lambda: verify.k1_decompress_cached_plain(ctbl, oktbl, *warm_args[:4]),
            lambda: verify.k1_decompress_cached(ctbl, oktbl, *warm_args[:4]))
        got = _verdicts(verify.k3_ladder(verify.k2_table(coords), sdig, kdig, coords, ok,
                                         warm_args[4]))
        check(bool((got == per_sig).all()),
              f"warm per-signature verdicts at {label} differ from the oracle at "
              f"{np.nonzero(got != per_sig)[0][:8].tolist()}")
        log(f"kernels: {label}: cold and warm verdicts equal the oracle; "
            f"{int((~per_sig).sum())} reject")

    for n in SR_SHAPES:
        block, per_sig = sr_in[n]
        label = f"{n} sr25519 signatures"
        args = [torch.from_numpy(a).to(dev) for a in osr.prepare_sr25519(block, n)]
        coords, ok, sdig, kdig = hold(stats, "k1r_decode", label,
                                      lambda: osr.k1r_decode_plain(*args[:6]),
                                      lambda: osr.k1r_decode(*args[:6]))
        tbl = hold(stats, "k2_table", label, lambda: verify.k2_table_plain(coords),
                   lambda: verify.k2_table(coords))
        out = hold(stats, "k3r_ladder", label,
                   lambda: osr.k3r_ladder_plain(tbl, sdig, kdig, coords, ok, args[6]),
                   lambda: osr.k3r_ladder(tbl, sdig, kdig, coords, ok, args[6]))
        got = _verdicts(out)
        check(bool((got == per_sig).all()),
              f"sr25519 verdicts at {label} differ from the oracle at "
              f"{np.nonzero(got != per_sig)[0][:8].tolist()}")
        log(f"kernels: {label}: verdicts equal the oracle; {int((~per_sig).sum())} reject")

    ep = epoch_cache.EpochEntry(b"smoke table", table_pub)
    pub_t = torch.from_numpy(np.ascontiguousarray(ep.pub_rows.T)).to(dev)
    coords, ok = hold(stats, "epoch_coords", f"{ep.vp} rows",
                      lambda: epoch_cache.epoch_coords_plain(pub_t),
                      lambda: epoch_cache.epoch_coords(pub_t))
    want_ok = [_edwards.decompress(r.tobytes()) is not None for r in ep.pub_rows]
    check(ok.cpu().numpy()[0].astype(bool).tolist() == want_ok,
          "table flags differ from the oracle's decompression")
    return stats


# -- slice phase ---------------------------------------------------------------


def expect_error(fn, exc_type, message: str) -> None:
    try:
        fn()
    except exc_type as e:
        check(str(e) == message, f"wrong error: {e!s:.120} (wanted {message:.120})")
        return
    raise SmokeFailure(f"no {exc_type.__name__} raised (wanted {message:.80})")


def _launched(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items() if v - before.get(k, 0)}


def _commits(vals, commit) -> tuple:
    """(tampered commit and its message, below-2/3 commit and its message)."""
    bad = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    cs = bad.signatures[TAMPER_AT]
    bad.signatures[TAMPER_AT] = dataclasses.replace(cs, signature=tamper(cs.signature))
    bad_msg = f"wrong signature (#{TAMPER_AT}): {bad.signatures[TAMPER_AT].signature.hex().upper()}"
    total = vals.total_voting_power()
    needed = total * 2 // 3
    low = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    got = total
    for i, v in enumerate(vals.validators):
        if got <= needed:
            break
        low.signatures[i] = CommitSig(BLOCK_ID_FLAG_ABSENT)
        got -= v.voting_power
    low_msg = f"invalid commit -- insufficient voting power: got {got}, needed more than {needed}"
    return bad, bad_msg, low, low_msg


def slice_phase(vals, commit, sr_vals, sr_commit, dev) -> dict:
    """verify_commit on the card on every path; returns each kernel's
    launches in its path's run: the WARM_CALLS RLC calls, one
    per-signature call, one warm per-signature call, one sr25519 call."""

    def vc(c, fn=validation.verify_commit, v=vals):
        return lambda: fn(CHAIN_ID, v, BLOCK, HEIGHT, c, device=dev)

    bad, bad_msg, low, low_msg = _commits(vals, commit)
    launches = {}
    with rlc_env(None):
        # (a) RLC: one set, cold then warm
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        kernels.reset_launches()
        per_call = []
        for _ in range(WARM_CALLS):
            before = dict(kernels.LAUNCHES)
            vc(commit)()
            per_call.append(_launched(before))
        launches.update({k: v for k, v in kernels.LAUNCHES.items() if v})
        stats = epoch_cache.stats()
        log(f"slice (a): {WARM_CALLS} verify_commit calls on one set, launches per call "
            f"{per_call}; epoch cache {stats}")
        check(per_call[0] == {"k1_rlc": 1, "k2_rlc": 1, "k3_rlc": 1},
              f"the cold call launched {per_call[0]}")
        check(per_call[1] == {"epoch_coords": 1, "k1_rlc_cached": 1, "k2_rlc": 1, "k3_rlc": 1},
              f"the first warm call launched {per_call[1]}")
        for c in per_call[2:]:
            check(c == {"k1_rlc_cached": 1, "k2_rlc": 1, "k3_rlc": 1},
                  f"a warm call launched {c}")
        check((stats["misses"], stats["hits"]) == (1, WARM_CALLS - 1),
              f"epoch cache misses/hits {stats['misses']}/{stats['hits']}")

        before = dict(kernels.LAUNCHES)
        expect_error(vc(bad), ValueError, bad_msg)
        check(_launched(before).get("k1_rlc_cached") == 1, "the tampered commit did not run warm")
        before = dict(kernels.LAUNCHES)
        vc(commit, validation.verify_commit_light)()
        light = _launched(before)
        check(light == {"k1_rlc_cached": 1, "k2_rlc": 1, "k3_rlc": 1},
              f"verify_commit_light launched {light}")
        expect_error(vc(low), ErrNotEnoughVotingPowerSigned, low_msg)
        epoch_cache.reset(depth=0)
        before = dict(kernels.LAUNCHES)
        expect_error(vc(bad), ValueError, bad_msg)
        check(_launched(before).get("k1_rlc") == 1, "the tampered commit did not run cold")
        log(f"slice (a): tampered signature #{TAMPER_AT} blamed warm and cold; "
            f"verify_commit_light warm {light}; low power rejected")

    want = {"k1_decompress": 1, "k2_table": 1, "k3_ladder": 1}
    with rlc_env("0"):
        # (b) per-signature, cold: the epoch cache off
        epoch_cache.reset(depth=0)
        kernels.reset_launches()
        vc(commit)()
        valid = _launched({})
        check(valid == want, f"the per-signature call launched {valid}")
        launches.update(valid)
        before = dict(kernels.LAUNCHES)
        expect_error(vc(bad), ValueError, bad_msg)
        bad_launches = _launched(before)
        check(bad_launches == want, f"the tampered per-signature call launched {bad_launches}")
        expect_error(vc(low), ErrNotEnoughVotingPowerSigned, low_msg)
        log(f"slice (b): per-signature valid commit verified, launches {want}; "
            f"tampered #{TAMPER_AT} blamed; low power rejected")

        # (c) per-signature, warm: the second call on a set reads its table
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        kernels.reset_launches()
        per_call = []
        for _ in range(3):
            before = dict(kernels.LAUNCHES)
            vc(commit)()
            per_call.append(_launched(before))
        warm_want = {"k1_decompress_cached": 1, "k2_table": 1, "k3_ladder": 1}
        check(per_call == [want, dict(warm_want, epoch_coords=1), warm_want],
              f"three per-signature calls on one set launched {per_call}")
        launches["k1_decompress_cached"] = kernels.LAUNCHES["k1_decompress_cached"]
        before = dict(kernels.LAUNCHES)
        expect_error(vc(bad), ValueError, bad_msg)
        check(_launched(before) == warm_want, "the tampered commit did not run warm")
        expect_error(vc(low), ErrNotEnoughVotingPowerSigned, low_msg)
        log(f"slice (c): per-signature calls on one set launched {per_call}; tampered "
            f"#{TAMPER_AT} blamed warm; low power rejected")

    with rlc_env(None):
        # (d) sr25519
        sr_bad, sr_bad_msg, sr_low, sr_low_msg = _commits(sr_vals, sr_commit)
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        kernels.reset_launches()
        vc(sr_commit, v=sr_vals)()
        sr_want = {"k1r_decode": 1, "k2_table": 1, "k3r_ladder": 1}
        got = _launched({})
        check(got == sr_want, f"the sr25519 call launched {got}")
        launches.update({k: got[k] for k in ("k1r_decode", "k3r_ladder")})
        before = dict(kernels.LAUNCHES)
        expect_error(vc(sr_bad, v=sr_vals), ValueError, sr_bad_msg)
        check(_launched(before) == sr_want, f"the tampered sr25519 call launched {_launched(before)}")
        expect_error(vc(sr_low, v=sr_vals), ErrNotEnoughVotingPowerSigned, sr_low_msg)
        stats = epoch_cache.stats()
        check((stats["misses"], stats["hits"]) == (0, 0),
              f"an sr25519 set was noted in the epoch cache: {stats}")
        log(f"slice (d): sr25519 valid commit verified, launches {sr_want}; tampered "
            f"#{TAMPER_AT} blamed; low power rejected; the epoch cache untouched")
    return launches


# -- timing --------------------------------------------------------------------


def count_products(units: dict) -> dict:
    """Multiply-adds per unit of each kernel, counted by running the plain
    versions on one unit (a lane, a table row, a signature) on the CPU
    with fe.mul and fe.sq counted per column (the kernels run the same
    formulas; a squaring is counted at the kernel's 210 products). Each
    count must equal the one stated in its source's header: a field
    product the count misses would otherwise lower the bound without an
    error. `units` maps a kernel to a thunk of its plain version."""
    counts = {"mul": 0, "sq": 0}
    real_mul, real_sq = fe.mul, fe.sq

    def mul(a, b):
        # a curve constant is one (20, 1) column broadcast over the batch
        counts["mul"] += max(a.shape[-1], b.shape[-1])
        return real_mul(a, b)

    def sq(a):
        counts["sq"] += a.shape[-1]
        return real_sq(a)

    counted = {}
    fe.mul, fe.sq = mul, sq
    try:
        for name, fn in units.items():
            counts["mul"] = counts["sq"] = 0
            fn()
            counted[name] = counts["mul"] * PRODUCTS_MUL + counts["sq"] * PRODUCTS_SQ
    finally:
        fe.mul, fe.sq = real_mul, real_sq
    check(counted == PRODUCTS_PER_UNIT,
          f"multiply-adds per unit {counted}, the sources state {PRODUCTS_PER_UNIT}")
    return counted


def _one_unit_thunks(cold, warm, table, sig, warm_sig, sr) -> dict:
    """Plain-version thunks over one unit of each kernel's inputs (CPU)."""
    a_t, r_t, scal_t, sok = (t[:, :1].cpu().contiguous() for t in cold)
    ctbl, oktbl, idx, r_rows, scal_rows = (t.cpu() for t in warm)
    pub_t = table[:, :1].cpu().contiguous()
    a, r, s, k, sok1 = (t[:, :1].cpu().contiguous() for t in sig)
    widx, wr, ws, wk = (t[:1].cpu().contiguous() for t in warm_sig[:4])
    sr1 = [t[:, :1].cpu().contiguous() for t in sr]
    c1, o1, d1 = rlc.k1_rlc_plain(a_t, r_t, scal_t)
    t1 = rlc.k2_rlc_plain(c1)
    vc, vo, vs, vk = verify.k1_decompress_plain(a, r, s, k)
    vt = verify.k2_table_plain(vc)
    rc, ro, rs, rk = osr.k1r_decode_plain(*sr1[:6])
    rt = verify.k2_table_plain(rc)
    return {
        "k1_decompress_cached": lambda: verify.k1_decompress_cached_plain(
            ctbl, oktbl, widx, wr, ws, wk),
        "k1r_decode": lambda: osr.k1r_decode_plain(*sr1[:6]),
        "k3r_ladder": lambda: osr.k3r_ladder_plain(rt, rs, rk, rc, ro, sr1[6]),
        "k1_rlc": lambda: rlc.k1_rlc_plain(a_t, r_t, scal_t),
        "k1_rlc_cached": lambda: rlc.k1_rlc_cached_plain(
            ctbl, oktbl, idx[: rlc.M].contiguous(), r_rows[: rlc.M].contiguous(),
            scal_rows[:1].contiguous()),
        "k2_rlc": lambda: rlc.k2_rlc_plain(c1),
        "k3_rlc": lambda: rlc.k3_rlc_plain(t1, d1, c1, o1, sok),
        "epoch_coords": lambda: epoch_cache.epoch_coords_plain(pub_t),
        "k1_decompress": lambda: verify.k1_decompress_plain(a, r, s, k),
        "k2_table": lambda: verify.k2_table_plain(vc),
        "k3_ladder": lambda: verify.k3_ladder_plain(vt, vs, vk, vc, vo, sok1),
    }


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


def profiled_calls(vals, commit, dev, path: str) -> list:
    """PROFILED verify_commit calls under torch.profiler. From the one
    trace, per call: its wall time, each host stage span of the path (the
    port's record_function spans), the rest of the call outside them, and
    the union of the card's kernel and copy intervals inside the call."""
    stages_of = PATHS[path]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED):
            with torch.profiler.record_function("verify_commit"):
                validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, commit, device=dev)
        torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    trace = TRACE_DIR / f"verify_commit_{path}.json"
    prof.export_chrome_trace(str(trace))
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    calls = sorted((e for e in spans if e["name"] == "verify_commit"), key=lambda e: e["ts"])
    check(len(calls) == PROFILED,
          f"trace holds {len(calls)} verify_commit spans, wanted {PROFILED}")
    out = []
    for c in calls:
        t0, t1 = c["ts"], c["ts"] + c["dur"]

        def inside(e):
            return t0 <= e["ts"] and e["ts"] + e["dur"] <= t1

        mine = [e for e in spans if inside(e)]
        missing = set(stages_of) - {e["name"] for e in mine}
        check(not missing, f"a traced {path} call lacks the spans {sorted(missing)}")
        stages = {s: sum(e["dur"] for e in mine if e["name"] == s) / 1e3 for s in stages_of}
        stages["rest"] = c["dur"] / 1e3 - sum(stages.values())
        dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
        out.append({
            "call_ms": c["dur"] / 1e3,
            "stages_ms": stages,
            "device_events": {k: sum(e.get("cat") == k for e in dev_ev) for k in DEVICE_CATS},
            "device_busy_ms": _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in dev_ev]),
        })
    return out


def time_path(path: str, vals, commit, dev) -> dict:
    """End-to-end times and the stage breakdown of one path."""
    env, depth, _ = PATH_SETUP[path]
    with rlc_env(env):
        epoch_cache.reset(depth=depth)
        for _ in range(2):  # the second call of a set is warm
            validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, commit, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        e2e = []
        for _ in range(REPEATS):
            t = time.perf_counter()
            validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, commit, device=dev)
            e2e.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev)
        prof = profiled_calls(vals, commit, dev, path)
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    e2e_ms = statistics.median(e2e) * 1e3
    stage_ms = {k: statistics.median(p["stages_ms"][k] for p in prof) for k in prof[0]["stages_ms"]}
    prof_ms = statistics.median(p["call_ms"] for p in prof)
    busy_ms = idle = None
    if sum(sum(p["device_events"].values()) for p in prof):
        busy_ms = statistics.median(p["device_busy_ms"] for p in prof)
        idle = statistics.median(1 - p["device_busy_ms"] / p["call_ms"] for p in prof)
    log(f"timing [{path}]: verify_commit {N_VALIDATORS} validators median {e2e_ms:.2f} ms over "
        f"{REPEATS} runs (min {min(e2e) * 1e3:.2f}, max {max(e2e) * 1e3:.2f}; "
        f"{N_VALIDATORS / (e2e_ms / 1e3):.0f} sigs/s); peak memory {peak} bytes")
    log(f"timing [{path}]: {PROFILED} profiled calls, median {prof_ms:.2f} ms; stages (median ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms.items()))
    if busy_ms is None:
        log(f"timing [{path}]: the profiler trace holds no device events: device busy and "
            "idle share not measured")
    else:
        log(f"timing [{path}]: device busy {busy_ms:.3f} ms (median), idle {idle:.1%} of the "
            f"call; device events per call {prof[0]['device_events']}")
    return {
        "verify_commit_ms": e2e_ms,
        "verify_commit_runs_ms": [x * 1e3 for x in e2e],
        "sigs_per_s": N_VALIDATORS / (e2e_ms / 1e3),
        "profiled_call_ms": prof_ms,
        "profiled_calls": prof,
        "stages_ms": stage_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": idle,
        "max_memory_allocated": peak,
    }


def kernel_timing(vals, block: EntryBlock, sr_block: EntryBlock, dev,
                  sm_clock_hz: float) -> list:
    """Each kernel's CUDA-event time on the main path's inputs, beside its
    bound; returns the kernel records without launches and plain times."""
    M = rlc.M
    bucket, g = rlc.plan_bucket(len(block))
    cold = [torch.from_numpy(a).to(dev) for a in rlc.prepare_rlc(block, bucket)]
    a_t, r_t, scal_t, sok = cold
    coords, ok, dig = rlc.k1_rlc(a_t, r_t, scal_t)
    tbl = rlc.k2_rlc(coords)
    out = rlc.k3_rlc(tbl, dig, coords, ok, sok)
    check(bool(out.all().item()), "the commit's lanes did not all accept")

    rows = np.arange(len(block), dtype=np.int32)  # the commit's rows are the set's
    wblock = EntryBlock(block.pub, block.sig, block.msgs, block.offsets, val_idx=rows,
                        epoch_key=vals.hash())
    ep = epoch_cache.EpochEntry(vals.hash(), vals.ed25519_columns()[0])
    pub_t = torch.from_numpy(np.ascontiguousarray(ep.pub_rows.T)).to(dev)
    ctbl, oktbl = epoch_cache.epoch_coords(pub_t)
    idx, r_rows, scal_rows, _ = (torch.from_numpy(a).to(dev)
                                 for a in rlc.prepare_rlc_cached(wblock, bucket, ep))
    warm = (ctbl, oktbl, idx, r_rows, scal_rows)
    wc, wo, wd = rlc.k1_rlc_cached(*warm)

    n = verify.bucket_for(len(block))
    sig = [torch.from_numpy(a).to(dev) for a in verify.prepare_compact(block, n)]
    vc, vo, vs, vk = verify.k1_decompress(*sig[:4])
    vt = verify.k2_table(vc)
    vout = verify.k3_ladder(vt, vs, vk, vc, vo, sig[4])
    check(bool(vout[0, : len(block)].all().item()), "the commit's signatures did not all verify")
    warm_sig = [torch.from_numpy(a).to(dev) for a in verify.prepare_compact_cached(wblock, n, ep)]
    wvc, wvo, wvs, wvk = verify.k1_decompress_cached(ctbl, oktbl, *warm_sig[:4])

    n_sr = verify.bucket_for(len(sr_block))
    sr = [torch.from_numpy(a).to(dev) for a in osr.prepare_sr25519(sr_block, n_sr)]
    rc, ro, rs, rk = osr.k1r_decode(*sr[:6])
    rt = verify.k2_table(rc)
    rout = osr.k3r_ladder(rt, rs, rk, rc, ro, sr[6])
    check(bool(rout[0, : len(sr_block)].all().item()),
          "the sr25519 commit's signatures did not all verify")

    runs = {
        "k1_rlc": (lambda: rlc.k1_rlc(a_t, r_t, scal_t), (a_t, r_t, scal_t, coords, ok, dig), g),
        "k1_rlc_cached": (lambda: rlc.k1_rlc_cached(*warm), warm + (wc, wo, wd), g),
        "k2_rlc": (lambda: rlc.k2_rlc(coords), (coords, tbl), g),
        "k3_rlc": (lambda: rlc.k3_rlc(tbl, dig, coords, ok, sok),
                   (tbl, dig, coords, ok, sok, out), g),
        "epoch_coords": (lambda: epoch_cache.epoch_coords(pub_t), (pub_t, ctbl, oktbl), ep.vp),
        "k1_decompress": (lambda: verify.k1_decompress(*sig[:4]),
                          tuple(sig[:4]) + (vc, vo, vs, vk), n),
        "k2_table": (lambda: verify.k2_table(vc), (vc, vt), n),
        "k3_ladder": (lambda: verify.k3_ladder(vt, vs, vk, vc, vo, sig[4]),
                      (vt, vs, vk, vc, vo, sig[4], vout), n),
        "k1_decompress_cached": (
            lambda: verify.k1_decompress_cached(ctbl, oktbl, *warm_sig[:4]),
            (ctbl, oktbl, *warm_sig[:4], wvc, wvo, wvs, wvk), n),
        "k1r_decode": (lambda: osr.k1r_decode(*sr[:6]), tuple(sr[:6]) + (rc, ro, rs, rk), n_sr),
        "k3r_ladder": (lambda: osr.k3r_ladder(rt, rs, rk, rc, ro, sr[6]),
                       (rt, rs, rk, rc, ro, sr[6], rout), n_sr),
    }
    products = count_products(_one_unit_thunks(cold, warm, pub_t, sig, warm_sig, sr))
    int_rate = SMS * INT32_LANES_PER_SM * sm_clock_hz
    records = []
    for name, (fn, tensors, units) in runs.items():
        ms = event_ms(fn, KERNEL_REPS)
        io_bytes = sum(t.nbytes for t in tensors)
        ops_ms = products[name] * units / int_rate * 1e3
        bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        source, replaces = KERNELS[name]
        records.append({
            "name": name,
            "route": "cuda",
            "source": f"tendermint_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "ms": ms,
            "bound_ms": bound_ms,
            "pct_of_bound": 100 * bound_ms / ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "products_per_unit": products[name],
            "units": units,
            "bytes": io_bytes,
        })
        log(f"timing: {name} {ms:.3f} ms over {units} units; bound "
            f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of it reached "
            f"({products[name] * units / 1e9:.3f} G "
            f"multiply-adds -> {ops_ms:.4f} ms, {io_bytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms)")
    return records


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
    resources = build_kernels()
    log(f"build phase: {time.perf_counter() - t:.1f} s")

    ctx = multiprocessing.get_context("spawn")
    # the cores this process may run on, not the host's count
    workers = min(16, len(os.sched_getaffinity(0)))
    with ctx.Pool(workers) as pool:
        sets = {}
        for key_type in ("ed25519", "sr25519"):
            t = time.perf_counter()
            sets[key_type] = build_commit(pool, key_type)
            log(f"data: {N_VALIDATORS}-validator {key_type} commit signed in "
                f"{time.perf_counter() - t:.1f} s by {workers} processes")
        vals, commit = sets["ed25519"]
        ents = commit_entries(commit, vals)
        sr_ents = commit_entries(sets["sr25519"][1], sets["sr25519"][0])
        edge = edge_entries()
        inputs = {lanes: sig_inputs(ents, edge, lanes, pool) for lanes in LANE_SHAPES}
        sr_edge = sr_edge_entries()
        sr_in = {n: sr_inputs(sr_ents, sr_edge, n, pool) for n in SR_SHAPES}
    table_pub = np.concatenate([
        np.frombuffer(b"".join(p for p, _, _ in edge), np.uint8).reshape(-1, 32),
        vals.ed25519_columns()[0],
    ])

    t = time.perf_counter()
    kstats = kernel_phase(inputs, sr_in, table_pub, dev)
    log(f"kernel phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    launches = slice_phase(vals, commit, *sets["sr25519"], dev)
    log(f"slice phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    paths = {p: time_path(p, *sets[PATH_SETUP[p][2]], dev) for p in PATHS}
    records = kernel_timing(vals, EntryBlock.from_entries(ents),
                            EntryBlock.from_entries(sr_ents), dev, sm_clock_hz)
    log(f"timing phase: {time.perf_counter() - t:.1f} s")
    log("paths (median ms): " + ", ".join(
        f"{p} {s['verify_commit_ms']:.2f} e2e / {s['device_busy_ms'] or 0:.3f} busy"
        for p, s in paths.items()))
    for r in records:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = kstats[r["name"]]["max_abs_err"]
        r["plain_ms"] = kstats[r["name"]]["plain_ms"]
        r.update(resources.get(r["name"], {}))
    log("summary: " + json.dumps(paths))
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
