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
   (csrc/merlin.cpp and csrc/host_prep.cpp: the sr25519 challenges, the
   fused commit prep, the ed25519 challenges, the RLC lane scalars, the
   vote sign bytes, the reduction mod L) with the host C++ compiler;
   then the data: a 10,000-validator ed25519 and sr25519 commit, each
   also decoded from its wire bytes (the columnar commit the timed calls
   use);
3. host: each C helper of the host library on the 10,000-validator
   inputs against its Python or numpy oracle (commit_prep.
   _prep_commit_numpy, backend._challenges, rlc._rlc_scalars_py with
   backend._s_below_l, canonical.compose_vote_sign_bytes_cols, Python's
   `% L`), outputs equal byte for byte; the C time (median of
   HOST_REPS) on the library's threads and on one, the oracle's time,
   and the host's CPU model and count;
4. kernels: each of the eleven CUDA entries on the card against its plain
   PyTorch version on the card: the RLC K1, cached K1, K2 and K3 at 64
   and 2,560 lanes; the per-signature K1, cached K1, K2 and K3 at 256 and
   10,240 signatures; the sr25519 K1r, K2 and K3r at 64 and 10,240
   signatures; and the epoch table build at 16,384 rows; over the
   ZIP-215 and ristretto edge batteries, padding and one tampered
   signature. Coordinates are compared after canonicalisation (the raw
   limbs of k2_table's table and of the coordinates of the four K1s,
   the epoch table and k1r_decode, rows 20..31 of each slot included),
   flags, digits and verdicts exactly, and the verdicts against the
   oracles;
5. slice: `types.validation.verify_commit` on the 10,000-validator
   commit decoded from its wire bytes on the card, on each path with the
   launch counters set to 0 just before it and read just after:
   (a) RLC, ed25519: five calls on one validator set, the first cold
       (k1_rlc), the rest warm (k1_rlc_cached, the epoch table built
       once), with the epoch cache's misses and hits; a tampered
       signature raises `wrong signature (#i): <HEX>` warm and cold, on
       a commit built from a list and on a decoded commit mutated in
       place;
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
   (e) the light path (light/verifier.py, light/client.py) on a chain of
       three 10,000-validator ed25519 sets, V1 the set of (a)-(c), V2
       half V1's keys and half new ones, V3 half V2's and none of V1's
       (powers from seeds 1016, 1017, 1018): headers 1, 2, 3 (V1), 10
       (V2) and 17 (V3), each commit signed in full and decoded from its
       wire bytes, the clock passed in, inside the trusting period.
       (e1) verify_adjacent 1 -> 2 warm through k1_rlc_cached, k2_rlc
       and k3_rlc once, its batch exactly the early-stop count of V1's
       powers; a signature tampered inside that prefix raises
       ErrInvalidHeader with its blame, one tampered past it
       (TAMPER_AT) is accepted, as the reference accepts it;
       (e2) verify_non_adjacent 1 -> 10: the trusting check by address
       against V1, then +2/3 of V2, three RLC kernels each (V2 cold,
       then its table built on its first warm call); 1 -> 17 raises
       ErrNotEnoughTrust; a commit carrying one address twice raises the
       double vote;
       (e3) the Client skipping from root 1 to 17 (V1 cannot trust V3,
       it bisects at 10), the witness agreeing, the store holding 1 and
       17; then sequentially from 1 to 3;
       (e4) one verify_adjacent on the per-signature kernels
       (TM_TPU_RLC=0);
6. timing, for each path (RLC cold, RLC warm, per-signature,
   per-signature warm, sr25519), on the decoded commit: the end-to-end
   verify_commit wall clock (warm, median of 20) and one call on the
   commit built from objects; the host library's calls in one call
   (each ed25519 path through the fused commit prep, span
   `commit.prep`; sr25519 through the object path, `commit.select` and
   `commit.sign_bytes`); a torch.profiler trace of 5 more calls, from
   which each call's host stages (the port's record_function spans), the
   rest of the call, and the card's busy time and idle share come; peak
   device memory. Then each kernel's time from CUDA events at the path's
   shape beside its plain version's time, its bound and the share of the
   bound it reaches (`pct_of_bound`). Then the light path:
   verify_adjacent 1 -> 2 and verify_non_adjacent 1 -> 10, REPEATS calls
   each on blocks decoded afresh for every call and on kept objects
   (median, min, max), PROFILED fresh calls a path traced with the
   spans light.checks, commit.*, rlc.*; one skipping Client call from a
   fresh store holding only the root, traced with light.store too; and
   the host costs of a freshly decoded 10,000-validator block (set
   decode and hash, header hash, commit decode and materialization).
   The traces are kept in build/traces/.

It prints one JSON line of the light path's checks and times (with the
card's name and power limit), one JSON line of kernel records, then the
`nvidia-smi` line, then, last, `{"ok": true, "device": {...}}`. Any failed check exits
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
import platform
import random
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import _edwards, _ristretto
from tendermint_tpu_torch.crypto import ed25519, sr25519
from tendermint_tpu_torch.ops import backend, commit_prep, epoch_cache, fe, host, kernels, rlc
from tendermint_tpu_torch.db import MemDB
from tendermint_tpu_torch.light import client as light_client
from tendermint_tpu_torch.light import verifier as light_verifier
from tendermint_tpu_torch.light.provider import ErrLightBlockNotFound, LightBlock, Provider
from tendermint_tpu_torch.light.store import LightStore
from tendermint_tpu_torch.ops import verify
from tendermint_tpu_torch.ops import sr25519 as osr
from tendermint_tpu_torch.ops.entry_block import EntryBlock
from tendermint_tpu_torch.types import validation
from tendermint_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
    SignedHeader,
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
# slice (e): the light chain's heights, each with its set (V1, V2, V3 of
# light_ranges), the trusting period and clock drift in seconds, the
# clock (inside the period), and a signature inside V1's early stop
LIGHT_HEIGHTS = {1: 0, 2: 0, 3: 0, 10: 1, 17: 2}
LIGHT_PERIOD = 14 * 24 * 3600.0
LIGHT_DRIFT = 10.0
LIGHT_NOW = canonical.Timestamp(T0_SECONDS + 3600, 0)
LIGHT_INSIDE = 100
REPEATS = 20  # warm end-to-end runs (median)
HOST_REPS = 5  # C calls a host helper's time is the median of
PROFILED = 5  # verify_commit calls traced by torch.profiler for the stages
KERNEL_REPS = 10  # launches per CUDA-event timing
TRACE_DIR = kernels.BUILD_DIR.parent / "traces"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's record_function spans on each batch path, in path order: the
# ed25519 paths take the fused commit prep, sr25519 the object path
FUSED_STAGES = ("commit.prep",)
OBJECT_STAGES = ("commit.select", "commit.sign_bytes")
PATHS = {
    "rlc_cold": FUSED_STAGES + ("rlc.prep", "rlc.h2d", "rlc.kernels", "rlc.d2h",
                                "rlc.expand"),
    "rlc_warm": FUSED_STAGES + ("rlc.prep", "rlc.gather", "rlc.h2d", "rlc.kernels",
                                "rlc.d2h", "rlc.expand"),
    "per_signature": FUSED_STAGES + ("verify.prep", "verify.h2d", "verify.kernels",
                                     "verify.d2h"),
    "per_signature_warm": FUSED_STAGES + ("verify.prep", "verify.gather", "verify.h2d",
                                          "verify.kernels", "verify.d2h"),
    "sr25519": OBJECT_STAGES + ("sr.prep", "sr.h2d", "sr.kernels", "sr.d2h"),
}
# the host library's calls in one verify_commit call of each path
HOST_HELPERS = ("commit_prep_fused", "ed25519_challenges_buf", "ed25519_rlc_prep",
                "vote_sign_bytes_batch_buf", "sr25519_challenges", "mod_l_many")
HOST_CALLS = {
    "rlc_cold": {"commit_prep_fused": 1, "ed25519_rlc_prep": 1},
    "rlc_warm": {"commit_prep_fused": 1, "ed25519_rlc_prep": 1},
    "per_signature": {"commit_prep_fused": 1, "ed25519_challenges_buf": 1},
    "per_signature_warm": {"commit_prep_fused": 1, "ed25519_challenges_buf": 1},
    "sr25519": {"vote_sign_bytes_batch_buf": 1, "sr25519_challenges": 1, "mod_l_many": 1},
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
# k1_rlc, k1_decompress and epoch_coords do not run those formulas: their
# bound counts the multiplies of their own formulation (fe25519.cuh
# decompress_wide), counted from the source. Per point, pow22523's chain
# and, around it, 3 squarings (v^2, (v^3)^2, r^2) and 6 multiplies (v^3,
# v^7, u v^7, u v^3, r, v r^2) on the wide field. A squaring forms 55
# 32 x 32 -> 64 products and a multiply 100, each one more for 19 times
# the top carry's low word; its 32-bit multiplies are 19 times limbs 5..9
# (a squaring) or 1..9 (a multiply) and 19 times the top carry's high
# word. On the 13-bit functions a point forms one squaring (y^2) and three
# multiplies (d y^2, r sqrt(-1), counted in every point as the plain
# version forms it, x y). A 32 x 32 -> 64 product takes
# INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK of the SM's 32-bit multiply-add
# slots a clock.
WIDE_AROUND_CHAIN = (3, 6)  # squarings, multiplies
WIDE_SQ = (56, 6)  # 32 x 32 -> 64 products, 32-bit multiplies
WIDE_MUL = (101, 10)
WIDE_13BIT = (1, 3)  # squarings, multiplies
# a point's 32 x 32 -> 64 products and 32-bit multiplies, as the headers of
# csrc/rlc.cu and csrc/verify.cu state them
WIDE_PER_POINT = (15_941, 3_104)
# IMAD.WIDE.U32 an SM issues a clock at most, in the form decompress_wide
# compiles to (an IMAD.WIDE.U32 of RZ a product, two summed into a column by
# IADD3 and IADD3.X): 27.11 at 12 chains a thread and 64 warps an SM,
# against 63.99 IMAD, on an H100 80GB HBM3 at 700 W (tools/torch_imad_rate.py;
# the programming guide gives no rate for it)
WIDE_PER_SM_CLOCK = 27.11
WIDE_POINTS_PER_UNIT = {"k1_rlc": 8, "k1_decompress": 2, "epoch_coords": 1}
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
# canonicalisation; the rest, and every output of the four K1s, the epoch
# table, k2_table and k1r_decode, raw
SLOT_OUTPUTS = {"k1_rlc": (), "k1_rlc_cached": (), "k2_rlc": (0,), "k3_rlc": (),
                "epoch_coords": (), "k1_decompress": (), "k1_decompress_cached": (),
                "k2_table": (), "k3_ladder": (), "k1r_decode": (), "k3r_ladder": ()}


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
def env(name: str, value):
    """Environment variable `name` set to `value` (None: unset) inside the
    block."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


# -- data ----------------------------------------------------------------------


def _vote_template() -> tuple:
    return canonical.canonical_vote_template(
        chain_id=CHAIN_ID,
        msg_type=canonical.SIGNED_MSG_TYPE_PRECOMMIT,
        height=HEIGHT,
        round_=ROUND,
        block_id=BLOCK.canonical(),
    )


def _seed(i: int) -> bytes:
    """Validator i's ed25519 seed: every slice's key i is the same key."""
    return hashlib.sha256(b"chip-smoke validator %d %d" % (SEED, i)).digest()


def _sign_validator(i: int) -> tuple:
    """(pub, timestamp, sig) of validator i's precommit for BLOCK. Each
    validator's timestamp depends only on i, so signing needs no pass over
    the sorted set first."""
    seed = _seed(i)
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


# -- host phase ----------------------------------------------------------------


def _median_ms(fn, reps: int) -> tuple:
    """(the last result, median wall ms) of reps calls of fn."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t) * 1e3)
    return out, statistics.median(times)


def _same_prep(got, want) -> bool:
    (gs, gt, gb), (ws, wt, wb) = got, want
    return (np.array_equal(gs, ws) and gt == wt and gb is not None and wb is not None
            and np.array_equal(gb.pub, wb.pub) and np.array_equal(gb.sig, wb.sig)
            and np.array_equal(gb.offsets, wb.offsets) and bytes(gb.msgs) == bytes(wb.msgs))


def _rlc_oracle(block: EntryBlock, z: np.ndarray, live: int) -> tuple:
    """host.ed25519_rlc_prep's outputs from the Python versions."""
    n = len(block)
    k = backend._challenges(np.ascontiguousarray(block.sig[:, :32]), block.pub,
                            block.messages())
    s_enc = np.zeros((live, 32), dtype=np.uint8)
    s_enc[:n] = block.sig[:, 32:]
    k_enc = np.zeros((live, 32), dtype=np.uint8)
    k_enc[:n] = np.frombuffer(k, dtype=np.uint8).reshape(n, 32)
    su = rlc._rlc_scalars_py(s_enc.tobytes(), k_enc.tobytes(), z.tobytes(), rlc.M)
    return k, su, backend._s_below_l(s_enc, n, live)


def host_phase(vals, commit: Commit, sr_block: EntryBlock) -> dict:
    """Each C helper of the host library at N_VALIDATORS signatures against
    its oracle on the same inputs: the decoded commit's fused prep (the
    verify_commit mode), its challenges, RLC prep and sign bytes, and the
    reduction mod L of the sr25519 commit's challenges."""
    out = {}

    def record(name, c_fn, oracle_fn, same):
        got, c_ms = _median_ms(c_fn, HOST_REPS)
        with env("TM_NATIVE_THREADS", "1"):
            got_1, c1_ms = _median_ms(c_fn, HOST_REPS)
        want, oracle_ms = _median_ms(oracle_fn, 1)
        check(same(got, want) and same(got_1, want), f"host helper {name} differs from its oracle")
        out[name] = {"c_ms": c_ms, "c_ms_1_thread": c1_ms, "oracle_ms": oracle_ms}
        log(f"host: {name} equals its oracle; C {c_ms:.3f} ms on {host.threads()} threads, "
            f"{c1_ms:.3f} ms on 1 (medians of {HOST_REPS}), oracle {oracle_ms:.3f} ms")
        return got

    cblock = commit.commit_block()
    check(cblock is not None, "the decoded commit has no columns")
    pub, power = vals.ed25519_columns()
    tpl_c = commit.sign_bytes_template(CHAIN_ID, BLOCK_ID_FLAG_COMMIT)
    tpl_n = commit.sign_bytes_template(CHAIN_ID, BLOCK_ID_FLAG_NIL)
    args = (cblock, pub, power, tpl_c[0], tpl_n[0], tpl_c[1],
            vals.total_voting_power() * 2 // 3, commit_prep.MODE_COUNT_FOR_BLOCK)
    _, _, block = record("commit_prep_fused", lambda: commit_prep.prep_commit(*args),
                         lambda: commit_prep._prep_commit_numpy(*args), _same_prep)
    check(len(block) == N_VALIDATORS, f"the fused prep selected {len(block)} signatures")
    r = np.ascontiguousarray(block.sig[:, :32])
    buf, offs = block.msgs_contiguous()
    record("ed25519_challenges_buf",
           lambda: host.ed25519_challenges_buf(r, block.pub, buf, offs),
           lambda: backend._challenges(r, block.pub, block.messages()),
           lambda g, w: g.tobytes() == w)
    live = -(-len(block) // rlc.M) * rlc.M
    z = rlc._gen_z(live)
    record("ed25519_rlc_prep",
           lambda: host.ed25519_rlc_prep(block.pub, block.sig, buf, offs, z, rlc.M, live),
           lambda: _rlc_oracle(block, z, live),
           lambda g, w: (g[0].tobytes(), g[1].tobytes() + g[2].tobytes()) == w[:2]
           and np.array_equal(g[3], w[2]))
    times = np.stack([cblock.ts_seconds, cblock.ts_nanos.astype(np.int64)], axis=1)
    record("vote_sign_bytes_batch_buf",
           lambda: host.vote_sign_bytes_batch_buf(tpl_c[0], tpl_c[1], times),
           lambda: canonical.compose_vote_sign_bytes_cols(tpl_c, times[:, 0], times[:, 1]),
           lambda g, w: bytes(g[0]) == bytes(w[0]) and np.array_equal(g[1], w[1]))
    sr_r = np.ascontiguousarray(sr_block.sig[:, :32])
    digests = host.sr25519_challenges(sr25519.SIGNING_CTX, sr_block.pub, sr_r, sr_block.msgs,
                                      sr_block.offsets)
    record("mod_l_many", lambda: host.mod_l_many(digests),
           lambda: b"".join((int.from_bytes(d.tobytes(), "little") % _edwards.L)
                            .to_bytes(32, "little") for d in digests),
           lambda g, w: g.tobytes() == w)
    out["threads"] = host.threads()
    out["cpu"] = cpu_model()
    out["cpus"] = os.cpu_count()
    out["cpus_usable"] = len(os.sched_getaffinity(0))
    log(f"host: the library runs {out['threads']} threads a call; host CPU {out['cpu']}, "
        f"{out['cpus']} CPUs, {out['cpus_usable']} usable by this process")
    return out


def cpu_model() -> str:
    """The host CPU's model name as lscpu gives it, with the machine type."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    names = [line.split(":", 1)[1].strip() for line in out.splitlines()
             if line.startswith(("Model name", "Vendor ID"))]
    return f"{' / '.join(names) or 'model not reported'} ({platform.machine()})"


def host_calls(fn) -> dict:
    """The host library's calls (HOST_HELPERS) while fn() runs."""
    counts = dict.fromkeys(HOST_HELPERS, 0)
    real = {k: getattr(host, k) for k in HOST_HELPERS}

    def counted(name):
        def call(*a, **kw):
            counts[name] += 1
            return real[name](*a, **kw)
        return call

    for k in HOST_HELPERS:
        setattr(host, k, counted(k))
    try:
        fn()
    finally:
        for k, f in real.items():
            setattr(host, k, f)
    return {k: v for k, v in counts.items() if v}


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
    """verify_commit on the card on every path, on commits decoded from
    their wire bytes; returns each kernel's launches in its path's run:
    the WARM_CALLS RLC calls, one per-signature call, one warm
    per-signature call, one sr25519 call."""

    def vc(c, fn=validation.verify_commit, v=vals):
        return lambda: fn(CHAIN_ID, v, BLOCK, HEIGHT, c, device=dev)

    bad, bad_msg, low, low_msg = _commits(vals, commit)
    launches = {}
    with env("TM_TPU_RLC", None):
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
        # stale columns: a decoded commit mutated in place detaches its view
        mutated = Commit.decode(commit.encode())
        check(mutated.commit_block() is not None, "the decoded commit has no columns")
        cs = mutated.signatures[TAMPER_AT]
        mutated.signatures[TAMPER_AT] = dataclasses.replace(cs, signature=tamper(cs.signature))
        expect_error(vc(mutated), ValueError, bad_msg)
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
        log(f"slice (a): tampered signature #{TAMPER_AT} blamed warm (built from a list, and "
            f"decoded then mutated) and cold; verify_commit_light warm {light}; low power "
            "rejected")

    want = {"k1_decompress": 1, "k2_table": 1, "k3_ladder": 1}
    with env("TM_TPU_RLC", "0"):
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

    with env("TM_TPU_RLC", None):
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


# -- slice (e): the light path ------------------------------------------------


def _light_pub(i: int) -> bytes:
    return _edwards.pubkey_from_seed(_seed(i))


def _light_sign(job: tuple) -> bytes:
    i, msg = job
    return _edwards.sign(_seed(i), msg)


def light_ranges() -> list:
    """The key ranges of V1, V2 and V3: V1 is the earlier slices' set,
    V2 shares half of it, V3 shares half of V2 and nothing of V1."""
    n = N_VALIDATORS
    return [(0, n), (n // 2, n + n // 2), (n, 2 * n)]


def build_light_chain(pool) -> dict:
    """The light chain's wire bytes: height -> (header, commit, validator
    set) encodings, every commit signed in full by its set."""
    ranges = light_ranges()
    pubs = pool.map(_light_pub, range(ranges[-1][1]), chunksize=64)
    sets = []
    for j, (lo, hi) in enumerate(ranges):
        # V1's powers are the earlier slices' draw over the same keys
        powers = np.random.default_rng(SEED + j).integers(1, 1000, hi - lo)
        sets.append(ValidatorSet.new([Validator.new(ed25519.PubKey(pubs[i]), int(p))
                                      for i, p in zip(range(lo, hi), powers)]))
    index = {p: i for i, p in enumerate(pubs)}
    headers, bids, votes = {}, {}, []  # votes: (height, address, key, time, message)
    prev = b""
    for h, j in LIGHT_HEIGHTS.items():
        vset = sets[j]
        d = hashlib.sha256(b"chip-smoke light %d" % h).digest()
        hdr = Header(
            chain_id=CHAIN_ID, height=h, time=canonical.Timestamp(T0_SECONDS + 10 * h, 0),
            last_block_id=(BlockID(prev, PartSetHeader(1, hashlib.sha256(prev).digest()))
                           if prev else BlockID()),
            last_commit_hash=d, data_hash=hashlib.sha256(d).digest(),
            validators_hash=vset.hash(), next_validators_hash=vset.hash(),
            consensus_hash=hashlib.sha256(b"consensus").digest(),
            app_hash=hashlib.sha256(b"app %d" % h).digest(),
            proposer_address=vset.get_proposer().address,
        )
        prev = hdr.hash()
        headers[h] = hdr
        bids[h] = BlockID(prev, PartSetHeader(1, hashlib.sha256(prev + b"parts").digest()))
        tpl = canonical.canonical_vote_template(
            chain_id=CHAIN_ID, msg_type=canonical.SIGNED_MSG_TYPE_PRECOMMIT, height=h,
            round_=0, block_id=bids[h].canonical())
        for v in vset.validators:
            i = index[v.pub_key.bytes()]
            ts = canonical.Timestamp(T0_SECONDS + 10 * h + 1, i + 1)
            votes.append((h, v.address, i, ts, canonical.compose_vote_sign_bytes(tpl, ts)))
    sigs = pool.map(_light_sign, [(i, msg) for _, _, i, _, msg in votes], chunksize=64)
    commit_sigs = {h: [] for h in LIGHT_HEIGHTS}
    for (h, addr, _, ts, _), sig in zip(votes, sigs):
        commit_sigs[h].append(CommitSig(BLOCK_ID_FLAG_COMMIT, addr, ts, sig))
    return {h: (headers[h].encode(), Commit(h, 0, bids[h], commit_sigs[h]).encode(),
                sets[j].encode())
            for h, j in LIGHT_HEIGHTS.items()}


class MemProvider(Provider):
    """The chain's light blocks from memory, with the heights asked for."""

    def __init__(self, blocks: dict):
        self.blocks = blocks
        self.asked = []

    def light_block(self, height: int) -> LightBlock:
        self.asked.append(height)
        if height == 0:
            height = max(self.blocks)
        if height not in self.blocks:
            raise ErrLightBlockNotFound(height)
        return self.blocks[height]


@contextlib.contextmanager
def batch_sizes():
    """The signatures of each ed25519 batch verified inside the block."""
    sizes = []
    real = backend.Ed25519DeviceBatchVerifier._verify_block

    def spy(self, block):
        sizes.append(len(block))
        return real(self, block)

    backend.Ed25519DeviceBatchVerifier._verify_block = spy
    try:
        yield sizes
    finally:
        backend.Ed25519DeviceBatchVerifier._verify_block = real


def early_stop(commit: Commit, trusted: ValidatorSet, num: int, den: int) -> int:
    """Signatures a light check of `trusted` (+2/3: 2, 3; trusting: 1, 3)
    selects from `commit` before its tally passes num/den of the set's
    power: the signers it knows, by address, in commit order."""
    rows = [trusted.get_by_address(cs.validator_address)[0] for cs in commit.signatures]
    power = trusted.ed25519_columns()[1]
    counted = np.array([power[r] for r in rows if r >= 0], dtype=np.int64)
    k = int(np.searchsorted(np.cumsum(counted), trusted.total_voting_power() * num // den,
                            side="right"))
    return min(k + 1, counted.size)


def _rewired(lb: LightBlock, edit) -> LightBlock:
    """lb with edit(list of CommitSigs) applied and its commit carried
    through its wire bytes again, as a node would receive it."""
    c = lb.signed_header.commit
    sigs = list(c.signatures)
    edit(sigs)
    commit = Commit.decode(Commit(c.height, c.round, c.block_id, sigs).encode())
    return LightBlock(SignedHeader(lb.signed_header.header, commit), lb.validators)


def light_phase(wire: dict, dev) -> dict:
    """Slice (e): the light path on the card at full width; each case's
    launches and batch sizes checked. Returns the early-stop counts."""
    blocks = {h: convert.light_block_from_wire(*w) for h, w in wire.items()}
    v1 = blocks[1].validators
    now = LIGHT_NOW
    trust = validation.DEFAULT_TRUST_LEVEL

    def adjacent(u, t=blocks[1]):
        return lambda: light_verifier.verify_adjacent(
            t.signed_header, u.signed_header, u.validators, LIGHT_PERIOD, now, LIGHT_DRIFT,
            device=dev)

    def non_adjacent(u, t=blocks[1]):
        return lambda: light_verifier.verify_non_adjacent(
            t.signed_header, t.validators, u.signed_header, u.validators, LIGHT_PERIOD, now,
            LIGHT_DRIFT, trust, device=dev)

    def run(fn):
        kernels.reset_launches()
        with batch_sizes() as sizes:
            fn()
        return _launched({}), sizes

    stops = {
        "light_v1": early_stop(blocks[2].signed_header.commit, v1, 2, 3),
        "trusting_v1_on_10": early_stop(blocks[10].signed_header.commit, v1, 1, 3),
        "light_v2": early_stop(blocks[10].signed_header.commit, blocks[10].validators, 2, 3),
        "trusting_v2_on_17": early_stop(blocks[17].signed_header.commit,
                                        blocks[10].validators, 1, 3),
        "light_v3": early_stop(blocks[17].signed_header.commit, blocks[17].validators, 2, 3),
    }
    log(f"slice (e): early-stop batch sizes from the powers {stops}")
    rlc_warm = {"k1_rlc_cached": 1, "k2_rlc": 1, "k3_rlc": 1}
    with env("TM_TPU_RLC", None):
        # (e1) adjacent 1 -> 2: cold, the table build, then warm
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        first = [run(adjacent(blocks[2]))[0] for _ in range(2)]
        check(first == [{"k1_rlc": 1, "k2_rlc": 1, "k3_rlc": 1}, dict(rlc_warm, epoch_coords=1)],
              f"the first two verify_adjacent calls launched {first}")
        got, sizes = run(adjacent(blocks[2]))
        check(got == rlc_warm, f"verify_adjacent warm launched {got}")
        check(sizes == [stops["light_v1"]], f"verify_adjacent's batch {sizes}, wanted "
              f"{stops['light_v1']}")
        inside = LIGHT_INSIDE
        check(inside < stops["light_v1"] <= TAMPER_AT < N_VALIDATORS,
              f"signatures {inside} and {TAMPER_AT} do not straddle the stop "
              f"{stops['light_v1']}")

        def tampered(at):
            def edit(sigs):
                sigs[at] = dataclasses.replace(sigs[at], signature=tamper(sigs[at].signature))
            return _rewired(blocks[2], edit)

        bad = tampered(inside)
        expect_error(adjacent(bad), light_verifier.ErrInvalidHeader,
                     f"wrong signature (#{inside}): "
                     f"{bad.signed_header.commit.signatures[inside].signature.hex().upper()}")
        # past the early stop the reference never looks at the signature
        adjacent(tampered(TAMPER_AT))()
        log(f"slice (e1): verify_adjacent 1 -> 2 warm launched {got}, batch {sizes}; "
            f"tampered #{inside} (inside the stop) blamed; tampered #{TAMPER_AT} (past the "
            f"stop at {stops['light_v1']}) accepted, as the reference accepts it")

        # (e2) non-adjacent 1 -> 10: trusting by address against V1, +2/3 of V2
        calls = [run(non_adjacent(blocks[10])) for _ in range(3)]
        want = [{"k1_rlc_cached": 1, "k1_rlc": 1, "k2_rlc": 2, "k3_rlc": 2},
                {"k1_rlc_cached": 2, "epoch_coords": 1, "k2_rlc": 2, "k3_rlc": 2},
                {"k1_rlc_cached": 2, "k2_rlc": 2, "k3_rlc": 2}]
        check([c for c, _ in calls] == want, f"verify_non_adjacent launched {calls}")
        check(all(s == [stops["trusting_v1_on_10"], stops["light_v2"]] for _, s in calls),
              f"verify_non_adjacent's batches {[s for _, s in calls]}")
        needed = v1.total_voting_power() // 3
        expect_error(non_adjacent(blocks[17]), light_verifier.ErrNotEnoughTrust,
                     f"invalid commit -- insufficient voting power: got 0, needed more than "
                     f"{needed}")
        known = [k for k, cs in enumerate(blocks[10].signed_header.commit.signatures)
                 if v1.get_by_address(cs.validator_address)[1] is not None][:2]

        def double(sigs):
            sigs[known[1]] = sigs[known[0]]

        dbl = _rewired(blocks[10], double)
        val = v1.get_by_address(dbl.signed_header.commit.signatures[known[0]].validator_address)[1]
        expect_error(non_adjacent(dbl), light_verifier.ErrInvalidHeader,
                     f"double vote from {val} ({known[0]} and {known[1]})")
        log(f"slice (e2): verify_non_adjacent 1 -> 10 launched {[c for c, _ in calls]}, "
            f"batches {calls[0][1]}; 1 -> 17 not enough trust; a double vote at "
            f"{known} rejected")

        # (e3) the client: skipping from 1 to 17, then sequential from 1 to 3
        primary, witness = MemProvider(blocks), MemProvider(blocks)
        client = light_client.Client(
            CHAIN_ID, light_client.TrustOptions(LIGHT_PERIOD, 1, blocks[1].hash()), primary,
            [witness], LightStore(MemDB()), now_fn=lambda: now, device=dev)
        t = time.perf_counter()
        got, sizes = run(lambda: client.verify_light_block_at_height(17, now))
        client_ms = (time.perf_counter() - t) * 1e3
        stored = [h for h in blocks if client.trusted_light_block(h) is not None]
        check(client.trusted_light_block(17).hash() == blocks[17].hash(), "wrong block at 17")
        check(primary.asked == [1, 17, 10] and witness.asked == [1, 17],
              f"the client asked the primary for {primary.asked}, the witness for "
              f"{witness.asked}")
        # the reference's skipping verification stores the target, not the
        # pivot it went through
        check(stored == [1, 17], f"the client's store holds {stored}")
        check(got == {"k1_rlc_cached": 3, "k1_rlc": 1, "k2_rlc": 4, "k3_rlc": 4},
              f"the skipping client launched {got}")
        check(sizes == [stops[k] for k in ("trusting_v1_on_10", "light_v2", "trusting_v2_on_17",
                                           "light_v3")], f"the skipping client's batches {sizes}")
        seq = light_client.Client(
            CHAIN_ID, light_client.TrustOptions(LIGHT_PERIOD, 1, blocks[1].hash()),
            MemProvider(blocks), [MemProvider(blocks)], LightStore(MemDB()), sequential=True,
            now_fn=lambda: now, device=dev)
        seq_got, seq_sizes = run(lambda: seq.verify_light_block_at_height(3, now))
        seq_stored = [h for h in blocks if seq.trusted_light_block(h) is not None]
        check(seq_stored == [1, 2, 3], f"the sequential client's store holds {seq_stored}")
        check(seq_got == {"k1_rlc_cached": 2, "k2_rlc": 2, "k3_rlc": 2},
              f"the sequential client launched {seq_got}")
        log(f"slice (e3): client skipping 1 -> 17 ({client_ms:.1f} ms) asked the primary for "
            f"{primary.asked} (bisected at 10), launched {got}, batches {sizes}; the witness "
            f"agreed; store {stored}; sequential 1 -> 3 launched {seq_got}, store {seq_stored}")

    with env("TM_TPU_RLC", "0"):
        # (e4) one adjacent step on the per-signature kernels, V1 warm
        got, sizes = run(adjacent(blocks[2]))
        want = {"k1_decompress_cached": 1, "k2_table": 1, "k3_ladder": 1}
        check(got == want, f"verify_adjacent per-signature launched {got}")
        check(sizes == [stops["light_v1"]], f"the per-signature batch {sizes}")
        log(f"slice (e4): verify_adjacent 1 -> 2 per-signature launched {got}")
    return {"early_stop": stops, "client_first_ms": client_ms}


LIGHT_STAGES = ("light.checks", "light.store", "commit.prep", "commit.select",
                "commit.sign_bytes", "rlc.prep", "rlc.gather", "rlc.h2d", "rlc.kernels",
                "rlc.d2h", "rlc.expand")


def _run_stats(runs_ms: list) -> dict:
    return {"median_ms": statistics.median(runs_ms), "min_ms": min(runs_ms),
            "max_ms": max(runs_ms), "runs_ms": runs_ms}


def light_timing(wire: dict, dev) -> dict:
    """verify_adjacent 1 -> 2 (warm) and verify_non_adjacent 1 -> 10:
    REPEATS calls on blocks decoded afresh for each call (decoding
    untimed: a light client receives each block new) and on the same
    objects (their hashes and columns kept); PROFILED fresh calls a path
    traced with the stages; one skipping client call from a fresh store
    holding only the root; and the host costs the path pays on a freshly
    decoded 10,000-validator block."""
    def fresh(h):
        return convert.light_block_from_wire(*wire[h])

    trust = validation.DEFAULT_TRUST_LEVEL

    def adjacent(t, u):
        light_verifier.verify_adjacent(t.signed_header, u.signed_header, u.validators,
                                       LIGHT_PERIOD, LIGHT_NOW, LIGHT_DRIFT, device=dev)

    def non_adjacent(t, u):
        light_verifier.verify_non_adjacent(t.signed_header, t.validators, u.signed_header,
                                           u.validators, LIGHT_PERIOD, LIGHT_NOW, LIGHT_DRIFT,
                                           trust, device=dev)

    paths = {"verify_adjacent": (adjacent, 1, 2), "verify_non_adjacent": (non_adjacent, 1, 10)}
    out = {}
    with env("TM_TPU_RLC", None):
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        for name, (fn, t, u) in paths.items():
            for _ in range(2):  # both sets warm, their tables built
                fn(fresh(t), fresh(u))
            runs = {"fresh": [], "reused": []}
            kept = (fresh(t), fresh(u))
            for _ in range(REPEATS):
                pair = (fresh(t), fresh(u))
                torch.cuda.synchronize()
                s = time.perf_counter()
                fn(*pair)
                runs["fresh"].append((time.perf_counter() - s) * 1e3)
                s = time.perf_counter()
                fn(*kept)
                runs["reused"].append((time.perf_counter() - s) * 1e3)
            pairs = [(fresh(t), fresh(u)) for _ in range(PROFILED)]
            prof = traced_calls(name, [lambda p=p: fn(*p) for p in pairs], f"light_{name}")
            out[name] = {k: _run_stats(v) for k, v in runs.items()}
            out[name]["profiled"] = _stage_medians(prof)
            log(f"light timing [{name}]: fresh median {out[name]['fresh']['median_ms']:.2f} ms "
                f"(min {out[name]['fresh']['min_ms']:.2f}, max "
                f"{out[name]['fresh']['max_ms']:.2f}), reused median "
                f"{out[name]['reused']['median_ms']:.2f} ms over {REPEATS} calls; profiled "
                f"{json.dumps(out[name]['profiled'])}")

        def client():
            blocks = {h: fresh(h) for h in wire}
            return light_client.Client(
                CHAIN_ID, light_client.TrustOptions(LIGHT_PERIOD, 1, blocks[1].hash()),
                MemProvider(blocks), [MemProvider(blocks)], LightStore(MemDB()),
                now_fn=lambda: LIGHT_NOW, device=dev)

        for _ in range(2):  # V3 noted, then its table built
            client().verify_light_block_at_height(17, LIGHT_NOW)
        c = client()
        prof = traced_calls("client", [lambda: c.verify_light_block_at_height(17, LIGHT_NOW)],
                            "light_client_skipping")
        out["client_skipping"] = _stage_medians(prof)
        log(f"light timing [client skipping 1 -> 17 from a fresh store holding the root, "
            f"every set warm]: "
            f"{json.dumps(out['client_skipping'])}")

    def each(make, fn):
        """Median ms of fn over PROFILED objects made afresh (untimed)."""
        objs = [make() for _ in range(PROFILED)]
        times = []
        for o in objs:
            t = time.perf_counter()
            fn(o)
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    host_ms = {
        "light_block_from_wire": _median_ms(lambda: fresh(10), PROFILED)[1],
        "validator_set_decode": _median_ms(lambda: ValidatorSet.decode(wire[10][2]),
                                           PROFILED)[1],
        "validator_set_hash": each(lambda: ValidatorSet.decode(wire[10][2]),
                                   lambda v: v.hash()),
        "validator_set_ed25519_columns": each(lambda: ValidatorSet.decode(wire[10][2]),
                                              lambda v: v.ed25519_columns()),
        "header_hash": each(lambda: Header.decode(wire[10][0]), lambda h: h.hash()),
        "commit_decode": _median_ms(lambda: Commit.decode(wire[10][1]), PROFILED)[1],
        "commit_materialize": each(lambda: Commit.decode(wire[10][1]),
                                   lambda c: list(c.signatures)),
    }
    out["host_ms"] = host_ms
    log(f"light timing: host costs on a fresh {N_VALIDATORS}-validator block (median ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in host_ms.items()))
    return out


def _stage_medians(prof: list) -> dict:
    """Medians over traced calls: the call, each light-path stage present,
    the rest, the card's busy time and its idle share."""
    present = [s for s in LIGHT_STAGES if any(s in p["spans_ms"] for p in prof)]
    stages = {s: statistics.median(p["spans_ms"].get(s, 0.0) for p in prof) for s in present}
    rest = [p["call_ms"] - sum(p["spans_ms"].get(s, 0.0) for s in present) for p in prof]
    out = {"calls": len(prof), "call_ms": statistics.median(p["call_ms"] for p in prof),
           "stages_ms": stages, "rest_ms": statistics.median(rest),
           "device_busy_ms": None, "device_idle_share": None}
    if sum(sum(p["device_events"].values()) for p in prof):
        out["device_busy_ms"] = statistics.median(p["device_busy_ms"] for p in prof)
        out["device_idle_share"] = statistics.median(
            1 - p["device_busy_ms"] / p["call_ms"] for p in prof)
    return out


# -- timing --------------------------------------------------------------------


def _count_mul_sq(fn) -> tuple:
    """(fe.mul, fe.sq) calls of fn(), counted per column (a curve constant
    is one (20, 1) column broadcast over the batch)."""
    counts = {"mul": 0, "sq": 0}
    real_mul, real_sq = fe.mul, fe.sq

    def mul(a, b):
        counts["mul"] += max(a.shape[-1], b.shape[-1])
        return real_mul(a, b)

    def sq(a):
        counts["sq"] += a.shape[-1]
        return real_sq(a)

    fe.mul, fe.sq = mul, sq
    try:
        fn()
    finally:
        fe.mul, fe.sq = real_mul, real_sq
    return counts["mul"], counts["sq"]


def wide_multiplies() -> dict:
    """Multiplies a point of decompress_wide: 32 x 32 -> 64 products
    (`wide`), 32-bit multiplies (`int32`) and the 32-bit multiply-add
    slots they take (`slots`, INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK a wide
    product). The chain's
    squarings and multiplies are counted by running fe.pow22523 (the same
    chain) on one column; the rest is as WIDE_* state. The counts must
    equal the ones stated in the sources' headers (WIDE_PER_POINT)."""
    n_mul, n_sq = _count_mul_sq(lambda: fe.pow22523(fe.from_ints([2])))
    n_sq += WIDE_AROUND_CHAIN[0]
    n_mul += WIDE_AROUND_CHAIN[1]
    wide = n_sq * WIDE_SQ[0] + n_mul * WIDE_MUL[0]
    int32 = (n_sq * WIDE_SQ[1] + n_mul * WIDE_MUL[1]
             + WIDE_13BIT[0] * PRODUCTS_SQ + WIDE_13BIT[1] * PRODUCTS_MUL)
    check((wide, int32) == WIDE_PER_POINT,
          f"decompress_wide's multiplies a point {(wide, int32)}, the sources state "
          f"{WIDE_PER_POINT}")
    return {"squarings": n_sq, "multiplies": n_mul, "wide": wide, "int32": int32,
            "slots": INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK * wide + int32}


def count_products(units: dict) -> dict:
    """Multiply-adds per unit of each kernel, counted by running the plain
    versions on one unit (a lane, a table row, a signature) on the CPU
    with fe.mul and fe.sq counted per column (the kernels run the same
    formulas; a squaring is counted at the kernel's 210 products). Each
    count must equal the one stated in its source's header: a field
    product the count misses would otherwise lower the bound without an
    error. `units` maps a kernel to a thunk of its plain version."""
    counted = {}
    for name, fn in units.items():
        n_mul, n_sq = _count_mul_sq(fn)
        counted[name] = n_mul * PRODUCTS_MUL + n_sq * PRODUCTS_SQ
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


def traced_calls(name: str, fns: list, trace_name: str) -> list:
    """Each fn() once inside a record_function(name) span, all under one
    torch.profiler trace (kept as build/traces/<trace_name>.json). Per
    call: its wall ms, the ms of each of the port's spans inside it by
    name, its device events by category, and the union of the card's
    kernel and copy intervals inside it."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns:
            with torch.profiler.record_function(name):
                fn()
        torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    trace = TRACE_DIR / f"{trace_name}.json"
    prof.export_chrome_trace(str(trace))
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    calls = sorted((e for e in spans if e["name"] == name), key=lambda e: e["ts"])
    check(len(calls) == len(fns), f"trace holds {len(calls)} {name} spans, wanted {len(fns)}")
    out = []
    for c in calls:
        t0, t1 = c["ts"], c["ts"] + c["dur"]

        def inside(e):
            return t0 <= e["ts"] and e["ts"] + e["dur"] <= t1

        spans_ms = {}
        for e in spans:
            if e is not c and inside(e):
                spans_ms[e["name"]] = spans_ms.get(e["name"], 0.0) + e["dur"] / 1e3
        dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
        out.append({
            "call_ms": c["dur"] / 1e3,
            "spans_ms": spans_ms,
            "device_events": {k: sum(e.get("cat") == k for e in dev_ev) for k in DEVICE_CATS},
            "device_busy_ms": _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in dev_ev]),
        })
    return out


def profiled_calls(vals, commit, dev, path: str) -> list:
    """PROFILED verify_commit calls under torch.profiler. From the one
    trace, per call: its wall time, each host stage span of the path (the
    port's record_function spans), the rest of the call outside them, and
    the union of the card's kernel and copy intervals inside the call."""
    stages_of = PATHS[path]
    calls = traced_calls(
        "verify_commit",
        [lambda: validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, commit, device=dev)]
        * PROFILED,
        f"verify_commit_{path}")
    out = []
    for c in calls:
        names = set(c["spans_ms"])
        missing = set(stages_of) - names
        check(not missing, f"a traced {path} call lacks the spans {sorted(missing)}")
        other = set(FUSED_STAGES + OBJECT_STAGES) - set(stages_of)
        check(not (names & other), f"a traced {path} call has the spans {sorted(names & other)}")
        stages = {s: c["spans_ms"][s] for s in stages_of}
        stages["rest"] = c["call_ms"] - sum(stages.values())
        out.append({
            "call_ms": c["call_ms"],
            "stages_ms": stages,
            "device_events": c["device_events"],
            "device_busy_ms": c["device_busy_ms"],
        })
    return out


def time_path(path: str, vals, commit, built, dev) -> dict:
    """End-to-end times and the stage breakdown of one path, on the
    decoded commit; one call on the commit built from objects."""
    rlc_flag, depth, _ = PATH_SETUP[path]

    def call(c):
        validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, c, device=dev)

    with env("TM_TPU_RLC", rlc_flag):
        epoch_cache.reset(depth=depth)
        for _ in range(2):  # the second call of a set is warm
            call(commit)
        calls = host_calls(lambda: call(commit))
        check(calls == HOST_CALLS[path],
              f"a {path} call made the host library calls {calls}, wanted {HOST_CALLS[path]}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        e2e = []
        for _ in range(REPEATS):
            t = time.perf_counter()
            call(commit)
            e2e.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev)
        t = time.perf_counter()
        call(built)
        built_ms = (time.perf_counter() - t) * 1e3
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
    log(f"timing [{path}]: host library calls a call {calls}; one call on the commit built "
        f"from objects {built_ms:.2f} ms")
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
        "object_built_call_ms": built_ms,
        "host_calls": calls,
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
    wide = wide_multiplies()
    log(f"timing: decompress_wide a point: {wide['squarings']} squarings and "
        f"{wide['multiplies']} multiplies on the wide field, {wide['wide']} 32 x 32 -> 64 "
        f"products and {wide['int32']} 32-bit multiplies, {wide['slots']:.0f} multiply-add slots")
    # the multiply-add slots a unit takes: the cold K1s' and the table's
    # from their own formulation, every other kernel's from the 13-bit
    # formulas
    ops = dict(products)
    for name, points in WIDE_POINTS_PER_UNIT.items():
        ops[name] = wide["slots"] * points
    int_rate = SMS * INT32_LANES_PER_SM * sm_clock_hz
    records = []
    for name, (fn, tensors, units) in runs.items():
        ms = event_ms(fn, KERNEL_REPS)
        io_bytes = sum(t.nbytes for t in tensors)
        ops_ms = ops[name] * units / int_rate * 1e3
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
            "ops_per_unit": ops[name],
            "products_per_unit": products[name],
            "units": units,
            "bytes": io_bytes,
        })
        log(f"timing: {name} {ms:.3f} ms over {units} units; bound "
            f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of it reached "
            f"({ops[name] * units / 1e9:.3f} G "
            f"multiply-add slots -> {ops_ms:.4f} ms, {io_bytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms)")
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
        # the commits as a node receives them: decoded from their wire bytes
        wire = {k: Commit.decode(c.encode()) for k, (_, c) in sets.items()}
        vals, commit = sets["ed25519"]
        ents = commit_entries(commit, vals)
        sr_ents = commit_entries(sets["sr25519"][1], sets["sr25519"][0])
        edge = edge_entries()
        inputs = {lanes: sig_inputs(ents, edge, lanes, pool) for lanes in LANE_SHAPES}
        sr_edge = sr_edge_entries()
        sr_in = {n: sr_inputs(sr_ents, sr_edge, n, pool) for n in SR_SHAPES}
        t = time.perf_counter()
        light_wire = build_light_chain(pool)
        light_sign_s = time.perf_counter() - t
        n_light = sum(hi - lo for lo, hi in (light_ranges()[j] for j in LIGHT_HEIGHTS.values()))
        log(f"data: the light chain (heights {list(LIGHT_HEIGHTS)}, {n_light} signatures by "
            f"{light_ranges()[-1][1]} keys) built and signed in {light_sign_s:.1f} s by "
            f"{workers} processes")
    table_pub = np.concatenate([
        np.frombuffer(b"".join(p for p, _, _ in edge), np.uint8).reshape(-1, 32),
        vals.ed25519_columns()[0],
    ])

    t = time.perf_counter()
    host_stats = host_phase(vals, wire["ed25519"], EntryBlock.from_entries(sr_ents))
    log(f"host phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    kstats = kernel_phase(inputs, sr_in, table_pub, dev)
    log(f"kernel phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    launches = slice_phase(vals, wire["ed25519"], sets["sr25519"][0], wire["sr25519"], dev)
    log(f"slice phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    light = light_phase(light_wire, dev)
    log(f"light phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    paths = {}
    for p in PATHS:
        key_type = PATH_SETUP[p][2]
        paths[p] = time_path(p, sets[key_type][0], wire[key_type], sets[key_type][1], dev)
    records = kernel_timing(vals, EntryBlock.from_entries(ents),
                            EntryBlock.from_entries(sr_ents), dev, sm_clock_hz)
    light["timing"] = light_timing(light_wire, dev)
    log(f"timing phase: {time.perf_counter() - t:.1f} s")
    log("paths (median ms): " + ", ".join(
        f"{p} {s['verify_commit_ms']:.2f} e2e / {s['device_busy_ms'] or 0:.3f} busy"
        for p, s in paths.items()))
    for r in records:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = kstats[r["name"]]["max_abs_err"]
        r["plain_ms"] = kstats[r["name"]]["plain_ms"]
        r.update(resources.get(r["name"], {}))
    log("summary: " + json.dumps({"paths": paths, "host": host_stats}))
    light.update(card=card, n_validators=N_VALIDATORS, signatures=n_light,
                 signing_s=light_sign_s)
    print(json.dumps({"light": light}), flush=True)
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
