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
   use); a 10,240-validator secp256k1 commit (bench.py schemes' set,
   power 100 each) and BASELINE.json config #4 (2,048 ed25519, 1,792
   sr25519 and 256 secp256k1 signatures, as bench._bench_mixed_curve
   builds it), and slice (h)'s 128-validator BLS12-381 committee (keys by
   successive addition of g1, their statuses) and its windows of
   aggregated commits, all signed by the spawn pool;
3. host: each C helper of the host library on the 10,000-validator
   inputs against its Python or numpy oracle (commit_prep.
   _prep_commit_numpy, backend._challenges, rlc._rlc_scalars_py with
   packing.s_below_l, canonical.compose_vote_sign_bytes_cols, Python's
   `% L`), outputs equal byte for byte; the C time (median of
   HOST_REPS) on the library's threads and on one, the oracle's time,
   and the host's CPU model and count;
4. kernels: each of the nineteen CUDA entries on the card against its
   plain PyTorch version on the card: the RLC K1, cached K1, K2 and K3 at 64
   and 2,560 lanes; the per-signature K1, cached K1, K2 and K3 at 256 and
   10,240 signatures; the sr25519 K1r, K2 and K3r at 64 and 10,240
   signatures; and the epoch table build at 16,384 rows; over the
   ZIP-215 and ristretto edge batteries, padding and one tampered
   signature; and the two secp256k1 kernels (secp_verify,
   secp_verify_cached) at 16, 250 and 10,240 rows over the secp256k1 edge
   battery (tampered s, wrong message, high S, a 63-byte signature, r =
   n, r = 0, s = 0, a key off the curve, an 04 prefix), two crafted rows
   where only the r + n candidate matches (one with it withheld),
   padding and the commit's signatures with one tampered: verdicts and
   the canonical final (X, Y, Z) exactly, the battery against the
   oracle. Coordinates are compared after canonicalisation (the raw
   limbs of k2_table's table and of the coordinates of the four K1s,
   the epoch table and k1r_decode, rows 20..31 of each slot included),
   flags, digits and verdicts exactly, and the verdicts against the
   oracles; and (h1) the two BLS12-381 kernels (bls_miller,
   bls_finalexp fused and by rows) at K = 4 over an 8-key committee and
   K = 16 over a 128-key one, over the BLS battery (valid commits, a
   wrong signature, a malformed, an identity and a non-subgroup G2
   signature, signers taking two crafted non-subgroup G1 keys, an
   identity aggregate, pad commits): apk, f_j and the residues word for
   word, and the codes they give equal to the battery's, and
   bls_finalexp by rows and fused on f = 0, f = 1 and seeded random rows
   (0 gives 0, 1 gives 1); and the
   op-graph kernels: sha512_challenge over a hash battery (R || A || M of
   64 to 256 bytes, the length field's boundaries, 1, 2 and 3 blocks, and
   padding rows) against its plain version, hashlib's SHA-512 and
   Python's % L, every byte, and over the RLC section's blocks at 256
   signatures (in the 1,024 bucket) and 10,240; og_verify and
   og_verify_cached (a shuffled epoch table) on those blocks with k
   hashed on the card, every verdict, against the oracle too; and (j1)
   commit_tally (csrc/tally.cu) at one row, 2,560 lanes of 4 (m = 4) and
   10,240 rows, each also all invalid, padding rows not live, powers up
   to 2^60 - 1, every word against its plain version and numpy's tally;
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
   (f) the asynchronous dispatcher (ops/pipeline.py; every ed25519
       batch of 64 signatures or more above, slice (a)'s included, goes
       through it, and every launch of (a) and (f) must come from its
       one dispatch thread):
       (f1) verify_commit on the 10,000-validator commit, RLC and
       TM_TPU_RLC=0, cold then warm: launches per call, blame and low
       power as in (a)-(c);
       (f2) four threads call verify_commit on one warm set at once: all
       return None; the launches are printed (k3_rlc below four is the
       dispatcher fusing their batches, which depends on timing);
       (f3) BASELINE.json config #5: verify_headers_pipelined over 1,000
       adjacent headers of one 128-validator set (bench.py's
       accelerator defaults, the chain built as
       bench._build_header_chain builds it, 128,128 signatures): every
       header verifies; a copy with a signature tampered at height 500
       raises `header 500: wrong signature (entry i)`, i the index a
       sequential loop of verify_commit_light blames; headers per
       second, batches and launches, and from a profiler trace the
       device busy time, its idle share, and the host-to-device copies
       that ran while a kernel ran (their streams beside the kernels');
       (f4) the batched light service (light/service.py) over slice
       (e)'s chain: 1 -> 2, 1 -> 10, 1 -> 17 and 1 -> 2 with a tampered
       signature submitted at once, each verdict equal to the
       sequential light.verifier.verify's;
       (f5) the verdicts of three batches held while eight more of the
       same layout reuse the dispatcher's buffers: unchanged, and
       host-owned;
       (f6) a batch whose host prep raises (rows outside its set's
       table) fails alone with a DispatchError; the next one verifies;
   (g) the secp256k1 lane (ops/secp_verify.py, csrc/secp256k1.cu):
       (g1) the 10,240-validator secp256k1 commit, decoded from its wire
       bytes, through prepare_commit_light, the shared dispatcher and
       conclude: cold (secp_verify), then warm (secp_verify_cached, the
       set's table uploaded once), one launch a call from the dispatch
       thread and no ed25519 kernel, 6,827 signatures to the light stop;
       a signature tampered at #4321 blamed warm and cold, one past the
       stop accepted, a commit below 2/3 refused;
       (g2) config #4 through ops/mixed.verify_mixed: all True; one
       tampered row in each lane, exactly those three False; each
       lane's kernels launched once a call; median of 20 and signatures
       a second;
       (g3) Secp256k1DeviceBatchVerifier and backend.verify_batch over
       the battery, equal to the oracle;
       (g4) a 10,240-signature secp256k1 block, then an uncached
       ed25519 block and an uncached secp256k1 block submitted at once
       while it runs: no batch holds two schemes, each job's verdicts
       right;
   (h) the BLS12-381 aggregated-commit lane (ops/bls_verify.py,
       csrc/bls12381.cu):
       (h2) bench.py bls's acceptance shape (AGG_r01.json): 128
       validators of power 100 (sk_i = i + 1), windows of 16 aggregated
       commits with every signer, through
       types.validation.prepare_aggregated_commit(k_hint=16), the
       shared dispatcher and conclude, the launch counters set to 0
       before each window: one warm-up window, three timed (median of
       the host prep, launch A's two kernels, end to end, aggregated
       commits a second), each exactly one launch A of width 16 and one
       final exponentiation row (the fused one); then a window with
       commit 7 carrying another height's aggregate: its exact blame,
       the other 15 accepted, launch B run once (16 rows);
       (h3) verify_aggregated_commit (the host walk) on two commits of
       that window and backend.verify_batch_bls_codes on the whole of
       it give the same verdicts and blame;
   (i) the op-graph path (TM_TPU_PALLAS=0, ops/ed25519_verify.py) on the
       10,000-validator commit decoded from its wire bytes, through the
       dispatcher: (i1) cold (epoch cache off): sha512_challenge and
       og_verify once a call, the fused prep building the RAM columns;
       (i2) warm: three calls on one set, the first cold, the next
       through og_verify_cached (the table built once); (i3) the host
       hash (TM_TPU_HOST_HASH=1): og_verify alone, the challenges from
       ed25519_challenges_buf, no RAM columns; in each the valid commit
       gives None, the tampered one `wrong signature (#i): <HEX>` and the
       one below 2/3 ErrNotEnoughVotingPowerSigned, every launch from the
       dispatch thread;
   (j) multi-device commit verification (ops/sharded.py, ops/mesh.py):
       (j2) the 10,000-validator commit through verify_commit_sharded
       (cold, and warm over each device's table), _pallas and _rlc, each
       on make_mesh(1) and on Mesh((cuda:0, cuda:0)), two shards of 5,120
       one after another on the card, the launch counters set to 0 just
       before: verdicts, tally and all_valid equal to backend.verify_batch
       and the host tally, each shard launching its verify kernels then
       one commit_tally, the tampered signature blamed at its row and its
       power left out; the median of 20 calls of each;
       (j3) the mesh dispatcher at bench.py multichip's shape: 24 jobs of
       1,024 signatures from V1 (cold), V2 and V3 (warm; slice (e)'s
       sets), one tampered, at mesh_lanes 1, 2 and 4 (lane_bucket 1,024)
       on the per-signature kernels and on the op-graph path: each job's
       verdicts equal to the single-lane dispatcher's; superbatches,
       signatures a second (median of 3), the card's busy time and idle
       share of a traced run; lanes above 1 are simulated lanes on one
       card, then placed lane by lane on Mesh((cuda:0,) * lanes); and a
       committee of 96 ed25519 and 32 secp256k1 validators through
       prepare_commit_scheme_split: its two blocks in one superbatch of
       two segments, the tampered commit blamed as the sequential path
       blames it;
6. timing, for each path (RLC cold, RLC warm, per-signature,
   per-signature warm, sr25519, op-graph cold, warm and host-hash), on
   the decoded commit: the end-to-end
   verify_commit wall clock (warm, median of 20) and one call on the
   commit built from objects; the host library's calls in one call
   (each ed25519 path through the fused commit prep, span
   `commit.prep`, which builds RAM columns on the op-graph device-hash
   paths only; sr25519 through the object path, `commit.select` and
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
   Then the warm secp256k1 light call of (g1): 20 calls (median, min,
   max), and 5 traced for its stages (commit.select, commit.sign_bytes,
   secp.prep, pipeline.*) and the card's busy time. Then the BLS kernels
   at (h2)'s shape (K = 16, the epoch table's 256 rows): bls_miller and
   the fused bls_finalexp and launch B's 16 rows over KERNEL_REPS,
   beside their bounds. The traces are kept in
   build/traces/.

The profiler traces every thread the process starts after it (the
dispatcher's spans run on its threads), so each traced window starts
the device's dispatcher anew.

It prints one JSON line of the light path's checks and times (with the
card's name and power limit), one of slice (f)'s, one of slice (g)'s,
one of slice (h)'s, one of slice (j)'s, one JSON line of kernel records
(commit_tally's launches those of (j2); the launches of
slices (a)-(d) and of config #5's first run in (f3); the secp256k1
kernels' of every call of (g1)-(g4) and of (j3)'s mixed committee; the
BLS kernels' of (h2)'s five windows; the op-graph kernels' of the valid
calls of (i), of (j2)'s shards and of (j3)'s mesh runs; the secp256k1
and op-graph kernels' split by slice in `launches_by_slice`), then the
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
import threading
import time

import numpy as np
import torch

from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import _edwards, _ristretto
from tendermint_tpu_torch.crypto import _weierstrass, bls12381, ed25519, secp256k1, sr25519
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.ops import backend, bls_verify, commit_prep, epoch_cache, fe, fe_bls, host
from tendermint_tpu_torch.ops import kernels, packing, rlc
from tendermint_tpu_torch.ops import mixed, pipeline, secp_verify, sharded
from tendermint_tpu_torch.ops import mesh as mesh_pack
from tendermint_tpu_torch.ops import sc_secp as secp_sc
from tendermint_tpu_torch.db import MemDB
from tendermint_tpu_torch.light import batch as light_batch
from tendermint_tpu_torch.light import client as light_client
from tendermint_tpu_torch.light import service as light_service
from tendermint_tpu_torch.light import verifier as light_verifier
from tendermint_tpu_torch.light.provider import ErrLightBlockNotFound, LightBlock, Provider
from tendermint_tpu_torch.light.store import LightStore
from tendermint_tpu_torch.ops import verify
from tendermint_tpu_torch.ops import ed25519_verify as og
from tendermint_tpu_torch.ops import sha512 as og_sha
from tendermint_tpu_torch.ops import sr25519 as osr
from tendermint_tpu_torch.ops.entry_block import AggBlock, EntryBlock
from tendermint_tpu_torch.types import validation
from tendermint_tpu_torch.types.block import (
    AggregatedCommit,
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
    SignedHeader,
    Version,
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
# slice (f): BASELINE.json config #5 at bench.py's accelerator defaults
# (bench.py:1254-1255), built as bench._build_header_chain builds it
HEADERS = 1000
HEADER_VALS = 128
HEADER_CHAIN = "bench-chain"
HEADER_T0 = 1_600_000_000
HEADER_TAMPER = (500, 17)  # (height, signature) tampered in (f3)
CONCURRENT = 4  # callers in (f2)
# slice (g): bench.py schemes' set (10,240 secp256k1 validators of power
# 100), its light stop (the signatures past 2/3 of the power), a
# signature tampered past it, the kernel shapes, BASELINE.json config
# #4 (ed25519, sr25519, secp256k1 signatures; bench._bench_mixed_curve)
# and (g4)'s ed25519 block
SECP_VALIDATORS = 10_240
SECP_POWER = 100
SECP_LIGHT_STOP = 6_827
SECP_LATE_TAMPER = 9_000
SECP_SHAPES = (16, 250, 10_240)
MIXED = (2_048, 1_792, 256)
G4_ED = 1_000
# slice (h): (h1)'s (K, committee keys) shapes; (h2)'s committee
# (bench.py bls, AGG_r01.json: 128 validators of power 100, sk_i = i + 1),
# its window of aggregated commits, the timed windows after one warm-up,
# and the commit tampered in the last window
BLS_SHAPES = ((4, 8), (16, 128))
BLS_VALIDATORS = 128
BLS_POWER = 100
BLS_WINDOW = 16
BLS_WINDOWS = 3
BLS_TAMPER = 7
BLS_EDGE_RANDOM = 6  # (h1)'s random rows beside f = 0 and f = 1
BLS_CHAIN = "bls-bench"
BLS_BLOCK = BlockID(hash=b"\x20" * 32, part_set_header=PartSetHeader(total=1, hash=b"\x20" * 32))
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
# (an ed25519 batch goes through the dispatcher: its prep on
# the coalescer thread, the copy, launch and readback on the dispatch
# thread, the wait, copy-out and blame pass in pipeline.resolve on the
# resolver thread; these spans do not nest in one another)
PIPELINE_STAGES = ("pipeline.h2d", "pipeline.d2h", "pipeline.resolve")
OG_STAGES = ("og.prep", "og.kernels")
PATHS = {
    "rlc_cold": FUSED_STAGES + ("rlc.prep", "rlc.kernels") + PIPELINE_STAGES,
    "rlc_warm": FUSED_STAGES + ("rlc.prep", "rlc.gather", "rlc.kernels") + PIPELINE_STAGES,
    "per_signature": FUSED_STAGES + ("verify.prep", "verify.kernels") + PIPELINE_STAGES,
    "per_signature_warm": FUSED_STAGES + ("verify.prep", "verify.gather", "verify.kernels")
    + PIPELINE_STAGES,
    "sr25519": OBJECT_STAGES + ("sr.prep", "sr.h2d", "sr.kernels", "sr.d2h"),
    "opgraph_cold": FUSED_STAGES + OG_STAGES + PIPELINE_STAGES,
    "opgraph_warm": FUSED_STAGES + ("og.prep", "og.gather", "og.kernels") + PIPELINE_STAGES,
    "opgraph_host_hash": FUSED_STAGES + OG_STAGES + PIPELINE_STAGES,
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
    "opgraph_cold": {"commit_prep_fused": 1},
    "opgraph_warm": {"commit_prep_fused": 1},
    "opgraph_host_hash": {"commit_prep_fused": 1, "ed25519_challenges_buf": 1},
}
# each path: (TM_TPU_RLC, TM_TPU_PALLAS, TM_TPU_HOST_HASH, epoch cache
# depth, the commit's key type)
PATH_SETUP = {
    "rlc_cold": (None, None, None, 0, "ed25519"),
    "rlc_warm": (None, None, None, epoch_cache.DEFAULT_DEPTH, "ed25519"),
    "per_signature": ("0", None, None, 0, "ed25519"),
    "per_signature_warm": ("0", None, None, epoch_cache.DEFAULT_DEPTH, "ed25519"),
    "sr25519": (None, None, None, epoch_cache.DEFAULT_DEPTH, "sr25519"),
    "opgraph_cold": (None, "0", None, 0, "ed25519"),
    "opgraph_warm": (None, "0", None, epoch_cache.DEFAULT_DEPTH, "ed25519"),
    "opgraph_host_hash": (None, "0", "1", 0, "ed25519"),
}
# the fused prep builds RAM blocks (the device hash's input) on these
# paths only
RAM_PATHS = ("opgraph_cold", "opgraph_warm")

# Bound model of one H100 (SXM, 700 W): 132 SMs, each 64 INT32 lanes a
# clock at the SM clock nvidia-smi reports as its maximum, and HBM3 at
# 3.35 TB/s. The work is the field products of the plain versions, each
# priced at the cheaper of its two formulations (product_slots): on the
# 13-bit limbs the 32-bit multiply-adds of the limb convolutions, 400 for
# a field multiply and 210 for a squaring; on the wide field (WIDE_MUL,
# WIDE_SQ) 248.4 and 138.2 multiply-add slots.
SMS = 132
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
PRODUCTS_MUL = 400
PRODUCTS_SQ = 210
# 13-bit multiply-adds per unit of work (an RLC lane, a table row, a
# signature) of the plain versions' formulas, as the headers of csrc/rlc.cu,
# csrc/verify.cu, csrc/sr25519.cu and csrc/ed25519_verify.cu state them
PRODUCTS_PER_UNIT = {
    "k1_rlc": 492_400, "k1_rlc_cached": 246_200, "k2_rlc": 203_520,
    "k3_rlc": 1_956_000, "epoch_coords": 61_550,
    "k1_decompress": 123_100, "k1_decompress_cached": 61_550, "k2_table": 50_880,
    "k3_ladder": 938_400, "k1r_decode": 128_740, "k3r_ladder": 926_160,
    "og_verify": 1_108_660, "og_verify_cached": 1_047_110,
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
# version forms it, x y), which the bound prices at product_slots as it
# does every other kernel's. A 32 x 32 -> 64 product takes
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
# The secp256k1 bound counts 32 x 32 -> 64 products only (what
# csrc/secp256k1.cu forms): 72 a multiply (64 schoolbook, 8 folding the
# high half), 44 a squaring at its cheaper formulation (28 cross
# products, 8 squares, 8 folding), 8 a multiply by 21;
# the multiplies by 2, 3 and 8 are shifts and additions. A signature's
# operations of each kind, as the source's header states them
# (secp_products counts them on the plain ladder). Bound: these products
# at WIDE_PER_SM_CLOCK a clock an SM.
SECP_OPS = {"mul": 2_475, "sq": 260, "x21": 412, "x2": 130, "x3": 271, "x8": 130}
SECP_WIDE = {"mul": 72, "sq": 44, "x21": 8}
SECP_WIDE_PER_SIG = sum(SECP_OPS[k] * w for k, w in SECP_WIDE.items())
# The BLS12-381 kernels (csrc/bls12381.cu) form 32 x 32 -> 64 products in
# their Montgomery product only, 288 a product (12 rows of 12 for a b and
# 12 for m p). Their Fp12 product is 36 Karatsuba Fp2 products (108), a
# line by a line 27, f^2 by two lines' product 90; a Miller step of the
# multi-Miller loop is f^2, four line evaluations (4), two line-by-line
# products and two products by them. A final exponentiation (the exact
# chain of the source's header): the easy part (two Fp12 products, the
# norm's inverse on one thread with its Fp inversion, a product by the
# Fp6 inverse (54), the p^2 map, a product); the hard part, 314 cyclotomic
# squares (Granger-Scott, 18), 52 Fp12 products, the p map (20) and a p^2
# map (10); 24 conversions. The Fp inversion (the binary extended
# Euclidean algorithm, additions and halvings) forms one product, by R^3.
# The CPU stand-in of tests/test_torch_bls.py counts them all
# (bls_fp_products).
BLS_WIDE_PER_FP = 288
BLS_F12_PRODUCT = 108
BLS_STEP_PRODUCTS = BLS_F12_PRODUCT + 4 * 4 + 2 * 27 + 2 * 90
BLS_FROB = (20, 10)  # the p and p^2 maps
BLS_CYCLO_PRODUCTS = 18
BLS_FP_INV = 1
# the norm's inverse: 3 Fp2 squares (2), 3 Fp2 products (3) for t0, t1, t2, 3 for N,
# N0^2 + N1^2, the inversion, 1/N (2), t_i / N (3 Fp2 products)
BLS_NORM_INVERSE = 3 * 2 + 3 * 3 + 3 * 3 + 2 + BLS_FP_INV + 2 + 3 * 3
BLS_FINALEXP_PRODUCTS = (3 * BLS_F12_PRODUCT + BLS_NORM_INVERSE + 54 + BLS_FROB[1]
                         + (62 + 4 * 63) * BLS_CYCLO_PRODUCTS + 52 * BLS_F12_PRODUCT
                         + sum(BLS_FROB) + 24)
# The BLS bounds count what the function needs on this run's data, not
# what these kernels do (bls_bound_products): Fp products of the cheapest
# published formulas, 288 wide products each at WIDE_PER_SM_CLOCK a clock
# an SM. A signer's key added into the sum: a mixed addition, 11 (RCB16
# Algorithm 8, a = 0). On the Fp6-over-Fp2 tower (the flat tower's
# coefficients reordered): an Fp12 product 54 (Karatsuba: 18 Fp2
# products of 3), a square 36 (two Fp6 products), a product by a sparse
# line 39 (13 Fp2 products, Aranha et al. 2011), a cyclotomic square 18
# (Granger-Scott: 9 Fp2 squares of 2), a Frobenius 15 (p, p^3) or 10
# (p^2), an inversion 97 with its one Fp inversion counted as nothing.
# A line at the projective apk takes 4 (c Z, lam X), at -g1 2 (lam x).
# A commit's two Miller loops share their squares (one multi-Miller loop
# gives f_j = f_0 f_1); the first square and the first two line products
# act on 1 or on a line and count nothing, nor does a skipped add's line
# (XI Y alone, a factor in Fp). A final exponentiation: the easy part
# (an inversion, two products, a p^2 Frobenius) and the hard part of
# Fuentes-Castaneda, Knapp and Rodriguez-Henriquez as the arkworks and
# zkcrypto crates run it (five exponentiations by |x| = 0xd201000000010000,
# 63 cyclotomic squares and 5 products each; 2 cyclotomic squares, 10
# products, the p, p^2 and p^3 Frobenius), which gives a fixed power of
# the exact value, 1 exactly where the exact value is.
BLS_MIXED_ADD = 11
BLS_F12_MUL, BLS_F12_SQ, BLS_LINE_MUL, BLS_CYCLO_SQ = 54, 36, 39, 18
BLS_LINE_EVAL = (4, 2)  # at the apk, at -g1
BLS_EASY_PART = 97 + 2 * 54 + 10
BLS_HARD_PART = 5 * (63 * 18 + 5 * 54) + 2 * 18 + 10 * 54 + 15 + 10 + 15
BLS_FINALEXP_BOUND = BLS_EASY_PART + BLS_HARD_PART
# The op-graph kernels' own products (csrc/ed25519_verify.cu's header):
# a quad a signature, each thread forming one product of every round, and
# every thread one decompression (threads 2 and 3 of og_verify's quad repeat
# threads 0 and 1's, og_verify_cached's four threads all decompress R).
# Per thread: these quad operations, a double a squaring and a multiply, a
# Niels add two multiplies, an add three (its to-Niels one), a to-Niels
# one; a decompression pow22523's chain and OG_AROUND_CHAIN around it, all
# on the wide field.
OG_QUAD_OPS = {"double": 259, "add_niels": 127, "add": 12, "to_niels": 16}
OG_AROUND_CHAIN = (4, 9)  # squarings (y^2, v^2, (v^3)^2, r^2), multiplies
# sha512_challenge's bound counts what SHA-512 mod L needs, not what
# csrc/sha512.cu does (as the BLS bounds do), in 32-bit operations at
# INT32_LANES_PER_SM a clock an SM, a 64-bit word in two halves, a
# three-input logic op (LOP3) or a funnel shift (SHF) one operation. A
# round: each big sigma three rotations of two funnel shifts and a
# three-way XOR a half (8), choose and majority a LOP3 a half (2 each),
# and T1 = h + S1 + ch + K + W, e' = d + T1 and a' = T1 + S0 + maj as
# three-input adds carrying into IADD3.X (4, 2, 2): 28. A scheduled word:
# two small sigmas (6 funnel shifts and a three-way XOR a half, 8 each)
# and a four-term sum (4): 20. The state update: eight 64-bit adds (16).
# The block's words are read once (bytes). The reduction mod L: the
# digest's words byte-swapped, then three folds of 2^252 = -c (mod L)
# (sha_fold_mod_l). The bound takes the blocks this run's messages use and
# one reduction each. kernel_ops is the source's own count (its header):
# 5,728 a block (80 rounds of 50, 64 scheduled words of 26, the loads and
# the state update 64) and 6,400 a reduction (a byte-wise Horner, 64 steps
# of 100).
SHA_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 16
SHA_KERNEL_OPS_PER_BLOCK = 80 * 50 + 64 * 26 + 64
SHA_KERNEL_OPS_REDUCE = 64 * 100
# L = 2^252 + SHA_C, SHA_C of 125 bits (4 words); the words of the part
# above 2^252 at each fold: 260 bits of the digest, then a signed 133-bit
# and a signed 7-bit part
SHA_C = _edwards.L - 2**252
SHA_C_WORDS = 4
SHA_FOLD_WORDS = (9, 5, 1)
# R || A || M totals of the hash battery: the empty message (64), the
# length field's boundaries (111 | 112 bytes end one block | need two,
# 239 | 240 the same for three) and RAM_MAX_LEN (256)
SHA_TOTALS = (64, 65, 111, 112, 127, 128, 175, 176, 239, 240, 255, 256)
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
    "secp_verify": ("secp256k1.cu", "tendermint_tpu/ops/secp_verify.py:139"),
    "secp_verify_cached": ("secp256k1.cu", "tendermint_tpu/ops/secp_verify.py:205"),
    "bls_miller": ("bls12381.cu", "tendermint_tpu/ops/bls_verify.py:247"),
    "bls_finalexp": ("bls12381.cu", "tendermint_tpu/ops/bls_verify.py:300"),
    "sha512_challenge": ("sha512.cu", "tendermint_tpu/ops/sha512.py:174"),
    "og_verify": ("ed25519_verify.cu", "tendermint_tpu/ops/ed25519_verify.py:152"),
    "og_verify_cached": ("ed25519_verify.cu", "tendermint_tpu/ops/ed25519_verify.py:273"),
    "commit_tally": ("tally.cu", "tendermint_tpu/ops/sharded.py:93"),
}
# outputs of each kernel that hold 32-row coordinate slots compared after
# canonicalisation; the rest, and every output of the four K1s, the epoch
# table, k2_table and k1r_decode, raw
SLOT_OUTPUTS = {"k1_rlc": (), "k1_rlc_cached": (), "k2_rlc": (0,), "k3_rlc": (),
                "epoch_coords": (), "k1_decompress": (), "k1_decompress_cached": (),
                "k2_table": (), "k3_ladder": (), "k1r_decode": (), "k3r_ladder": (),
                "secp_verify": (), "secp_verify_cached": (), "bls_miller": (),
                "bls_finalexp": (), "sha512_challenge": (), "og_verify": (),
                "og_verify_cached": (), "commit_tally": ()}


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


def _secp_sk(i: int) -> "secp256k1.PrivKey":
    """Validator i's secp256k1 key: every slice's key i is the same key."""
    return secp256k1.PrivKey(hashlib.sha256(b"chip-smoke secp validator %d %d" % (SEED, i))
                             .digest())


def secp_edge_entries() -> list:
    """secp256k1 (pub33, msg, sig) entries over every accept and reject
    branch: valid signatures of four keys; a tampered s (still lower-S),
    a wrong message, the high-S twin of a valid signature, a 63-byte
    signature, r = n, r = 0, s = 0, a key whose x is not on the curve, a
    key with the uncompressed prefix 04."""
    out = []
    for i in range(4):
        sk = secp256k1.PrivKey(bytes([i + 1]) * 32)
        msg = b"secp-edge-%d" % i
        out.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    pk, msg, sig = out[0]
    n = secp256k1.N
    s = int.from_bytes(sig[32:], "big")
    out.append((pk, msg, sig[:63] + bytes([sig[63] ^ 1])))
    out.append((pk, b"other", sig))
    out.append((pk, msg, sig[:32] + (n - s).to_bytes(32, "big")))
    out.append((pk, msg, sig[:63]))
    out.append((pk, msg, n.to_bytes(32, "big") + sig[32:]))
    out.append((pk, msg, bytes(32) + sig[32:]))
    out.append((pk, msg, sig[:32] + bytes(32)))
    x = 5  # x^3 + 7 = 132 is not a square mod p
    assert _weierstrass.decompress(b"\x02" + x.to_bytes(32, "big")) is None
    out.append((b"\x02" + x.to_bytes(32, "big"), msg, sig))
    out.append((b"\x04" + pk[1:], msg, sig))
    return out


def secp_wrap_rows() -> tuple:
    """Two kernel rows whose ladder ends at a point P with x(P) >= n:
    Q = P, u1 = 0, u2 = 1, candidates (x - n, x) and (x - n, x - n).
    Only the second candidate matches: the first row verifies, the
    second does not. Returns (qx, qy, scalars, signs, r1, r2, ok_host)
    rows of both, as secp_verify.prepare_rows lays them out."""
    n = secp256k1.N
    x = n
    while _weierstrass.decompress(b"\x02" + x.to_bytes(32, "big")) is None:
        x += 1
    qx, qy = _weierstrass.decompress(b"\x02" + x.to_bytes(32, "big"))
    f = secp_verify.field_to_limbs
    scal = secp_sc.scalars_to_limbs([0, 0, 1, 0]).reshape(1, 4, -1)
    return (f([qx, qx]), f([qy, qy]), np.concatenate([scal, scal]),
            np.zeros((2, 4), dtype=np.int32), f([x - n, x - n]), f([x, x - n]),
            np.ones(2, dtype=bool))


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
            m = re.search(r"for _ZN(?:3edw|4secp|3bls|3sha|5tally)\d+(\w+?)_kernelE", line)
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
            and np.array_equal(gb.offsets, wb.offsets) and bytes(gb.msgs) == bytes(wb.msgs)
            and all((getattr(gb, c) is None) == (getattr(wb, c) is None)
                    and (getattr(gb, c) is None or np.array_equal(getattr(gb, c), getattr(wb, c)))
                    for c in ("ram_hi", "ram_lo", "ram_counts")))


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
    return k, su, packing.s_below_l(s_enc, n, live)


def host_phase(vals, commit: Commit, sr_block: EntryBlock) -> dict:
    """Each C helper of the host library at N_VALIDATORS signatures against
    its oracle on the same inputs: the decoded commit's fused prep (the
    verify_commit mode), without and with the op-graph path's RAM columns
    (commit_prep._fill_ram), its challenges, RLC prep and sign bytes, and the
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
    check(block.ram_hi is None, "the fused prep built RAM columns unasked")
    _, _, rblock = record(
        "commit_prep_fused_ram", lambda: commit_prep.prep_commit(*args, True),
        lambda: commit_prep._prep_commit_numpy(*args, True), _same_prep)
    check(rblock.ram_hi is not None and rblock.ram_hi.shape == (N_VALIDATORS, 48),
          "the fused prep built no RAM columns for the op-graph path")
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


def sha_battery() -> tuple:
    """The hash battery: an EntryBlock whose R || A || M totals are
    SHA_TOTALS (the empty message, the length field's boundaries, 256
    bytes), and the expected k rows of it padded by 4 padding rows
    (hashlib's SHA-512 and Python's % L)."""
    rng = np.random.default_rng(SEED)
    ents = [(rng.bytes(32), rng.bytes(t - 64), rng.bytes(64)) for t in SHA_TOTALS]
    msgs = [s[:32] + p + m for p, m, s in ents] + [og_sha._PAD_PAIR] * 4
    want = [(int.from_bytes(hashlib.sha512(m).digest(), "little") % _edwards.L)
            .to_bytes(32, "little") for m in msgs]
    return EntryBlock.from_entries(ents), want


def og_kernel_phase(stats: dict, inputs: dict, dev) -> None:
    """The op-graph kernels against their plain versions on the card:
    sha512_challenge over the hash battery (against hashlib and % L too)
    and over each shape's R || A || M; og_verify and og_verify_cached over
    the RLC section's blocks (the ZIP-215 edge battery, commit signatures
    with one tampered, padding to the op-graph bucket: 256 signatures in
    the 1,024 bucket, 10,240 in 10,240), every verdict, against the
    oracle too, with k hashed on the card."""
    block, want = sha_battery()
    n = len(block) + 4
    hi, lo, counts = og_sha.pad_ram_block(block, n, og_sha.MAX_LEN)
    check(sorted(set(counts.tolist())) == [1, 2, 3], f"the hash battery uses blocks {counts}")
    args = [torch.from_numpy(og_sha.as_int32(hi)).to(dev),
            torch.from_numpy(og_sha.as_int32(lo)).to(dev), torch.from_numpy(counts).to(dev)]
    k = hold(stats, "sha512_challenge", f"the {n}-row hash battery",
             lambda: og_sha.sha512_challenge_plain(*args), lambda: og_sha.sha512_challenge(*args))
    check([bytes(r) for r in k.cpu().numpy()] == want,
          "sha512_challenge differs from hashlib's SHA-512 mod L")
    log(f"kernels: the hash battery's {n} rows (R || A || M of {list(SHA_TOTALS)} bytes and 4 "
        "padding rows) equal hashlib's SHA-512 mod L")
    for lanes in LANE_SHAPES:
        block, per_sig = inputs[lanes]
        live = len(block)
        batch = og.prepare_batch(block, device_hash=True)
        n = batch.bucket
        label = f"{live} signatures in {n}"
        a, r, s, hi, lo, counts, sok = (torch.from_numpy(x).to(dev) for x in batch.args)
        k = hold(stats, "sha512_challenge", label,
                 lambda: og_sha.sha512_challenge_plain(hi, lo, counts),
                 lambda: og_sha.sha512_challenge(hi, lo, counts))
        oracle = np.ones(n, dtype=bool)
        oracle[:live] = per_sig[:live]
        out = hold(stats, "og_verify", label, lambda: og.og_verify_plain(a, r, s, k, sok),
                   lambda: og.og_verify(a, r, s, k, sok))
        got = out.cpu().numpy().astype(bool)
        check(bool((got == oracle).all()),
              f"og_verify verdicts at {label} differ from the oracle at "
              f"{np.nonzero(got != oracle)[0][:8].tolist()}")
        wblock, ep = with_epoch(block, lanes + 1)
        pub_t = torch.from_numpy(np.ascontiguousarray(ep.pub_rows.T)).to(dev)
        ctbl, oktbl = epoch_cache.epoch_coords_plain(pub_t)
        idx = torch.from_numpy(epoch_cache.table_columns(wblock, n, ep)).to(dev)
        out = hold(stats, "og_verify_cached", label,
                   lambda: og.og_verify_cached_plain(ctbl, oktbl, idx, r, s, k, sok),
                   lambda: og.og_verify_cached(ctbl, oktbl, idx, r, s, k, sok))
        got = out.cpu().numpy().astype(bool)
        check(bool((got == oracle).all()),
              f"og_verify_cached verdicts at {label} differ from the oracle at "
              f"{np.nonzero(got != oracle)[0][:8].tolist()}")
        log(f"kernels: op-graph {label}: cold and warm verdicts equal the oracle; "
            f"{int((~oracle).sum())} reject")


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
    with env("TM_TPU_RLC", None), launch_threads() as launchers:
        # (a) RLC: one set, cold then warm, through the device's dispatcher
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
    check_dispatcher_launched(launchers, dev, "slice (a)")

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


def fused_ram(fn) -> list:
    """Whether each commit_prep_fused call while fn() runs built RAM
    columns (the device hash's input)."""
    built = []
    real = host.commit_prep_fused

    def spy(*a, **kw):
        out = real(*a, **kw)
        built.append(out[2] is not None and out[2][4] is not None)
        return out

    host.commit_prep_fused = spy
    try:
        fn()
    finally:
        host.commit_prep_fused = real
    return built


def opgraph_phase(vals, commit, dev) -> dict:
    """Slice (i): the op-graph path (TM_TPU_PALLAS=0) on the card, on the
    10,000-validator commit decoded from its wire bytes, through the
    dispatcher. Returns each kernel's launches in its path's run (the
    launch counters set to 0 just before): the valid commit's calls of
    (i1) opgraph_cold, (i2) opgraph_warm and (i3) opgraph_host_hash, summed."""

    def vc(c):
        return lambda: validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, c, device=dev)

    bad, bad_msg, low, low_msg = _commits(vals, commit)
    cold = {"sha512_challenge": 1, "og_verify": 1}
    warm = {"sha512_challenge": 1, "og_verify_cached": 1}
    with env("TM_TPU_PALLAS", "0"), env("TM_TPU_HOST_HASH", None), env("TM_TPU_RLC", None), \
            launch_threads() as launchers:
        # (i1) cold: the epoch cache off
        epoch_cache.reset(depth=0)
        kernels.reset_launches()
        ram = fused_ram(vc(commit))
        got = _launched({})
        check(got == cold, f"the op-graph cold call launched {got}")
        check(ram == [True], f"the op-graph cold call's fused prep built RAM columns {ram}")
        launches = dict(got)
        before = dict(kernels.LAUNCHES)
        expect_error(vc(bad), ValueError, bad_msg)
        check(_launched(before) == cold, f"the tampered cold call launched {_launched(before)}")
        expect_error(vc(low), ErrNotEnoughVotingPowerSigned, low_msg)
        log(f"slice (i1): op-graph cold valid commit verified, launches {got}, RAM columns "
            f"built by the fused prep; tampered #{TAMPER_AT} blamed; low power rejected")

        # (i2) warm: three calls on one set, the first cold
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        kernels.reset_launches()
        per_call = []
        for _ in range(3):
            before = dict(kernels.LAUNCHES)
            vc(commit)()
            per_call.append(_launched(before))
        check(per_call == [cold, dict(warm, epoch_coords=1), warm],
              f"three op-graph calls on one set launched {per_call}")
        for c in per_call:
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
        before = dict(kernels.LAUNCHES)
        expect_error(vc(bad), ValueError, bad_msg)
        check(_launched(before) == warm, "the tampered commit did not run warm")
        expect_error(vc(low), ErrNotEnoughVotingPowerSigned, low_msg)
        log(f"slice (i2): op-graph calls on one set launched {per_call}; tampered "
            f"#{TAMPER_AT} blamed warm; low power rejected")

        # (i3) the host hash: cold, TM_TPU_HOST_HASH=1
        with env("TM_TPU_HOST_HASH", "1"):
            epoch_cache.reset(depth=0)
            kernels.reset_launches()
            calls = host_calls(vc(commit))
            got = _launched({})
            check(got == {"og_verify": 1}, f"the op-graph host-hash call launched {got}")
            launches["og_verify"] += 1
            check(calls == HOST_CALLS["opgraph_host_hash"],
                  f"the op-graph host-hash call made the host calls {calls}")
            before = dict(kernels.LAUNCHES)
            expect_error(vc(bad), ValueError, bad_msg)
            check(_launched(before) == {"og_verify": 1}, "the tampered host-hash call launched "
                  f"{_launched(before)}")
            expect_error(vc(low), ErrNotEnoughVotingPowerSigned, low_msg)
            ram = fused_ram(vc(commit))
            check(ram == [False], f"the host-hash call's fused prep built RAM columns {ram}")
        log(f"slice (i3): op-graph host-hash valid commit verified, launches {got}, host calls "
            f"{calls}; tampered #{TAMPER_AT} blamed; low power rejected")
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    check_dispatcher_launched(launchers, dev, "slice (i)")
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
                "commit.sign_bytes", "rlc.prep", "rlc.gather", "rlc.kernels") + PIPELINE_STAGES


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
            prof = traced_calls(name, [lambda p=p: fn(*p) for p in pairs], f"light_{name}",
                                warm=lambda: fn(fresh(t), fresh(u)))
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
                            "light_client_skipping",
                            warm=lambda: client().verify_light_block_at_height(17, LIGHT_NOW))
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


# -- slice (f): the dispatcher ------------------------------------------------


@contextlib.contextmanager
def launch_threads():
    """The idents of the threads that launch a kernel inside the block."""
    idents = set()
    real = kernels.launch

    def spy(name, *args):
        idents.add(threading.get_ident())
        return real(name, *args)

    kernels.launch = spy
    try:
        yield idents
    finally:
        kernels.launch = real


def check_dispatcher_launched(launchers: set, dev, what: str) -> None:
    """Every launch of `what` came from the device's one dispatch thread."""
    v = pipeline.shared_verifier(dev)
    check(launchers == {v._dispatch_thread.ident},
          f"{what}: kernels launched from threads {launchers}, the dispatch thread is "
          f"{v._dispatch_thread.ident}")
    check(v.dispatch_thread_idents == {v._dispatch_thread.ident}
          and threading.get_ident() not in v.dispatch_thread_idents,
          f"{what}: the device was touched from {v.dispatch_thread_idents}")


def _header_seed(i: int) -> bytes:
    """bench._build_header_chain's key i."""
    return (i + 7).to_bytes(32, "little")


def _header_pub(i: int) -> bytes:
    return _edwards.pubkey_from_seed(_header_seed(i))


def _header_sign(job: tuple) -> bytes:
    i, msg = job
    return _edwards.sign(_header_seed(i), msg)


def build_header_chain(pool) -> tuple:
    """BASELINE.json config #5's chain as bench._build_header_chain builds
    it at bench.py's accelerator defaults: HEADERS + 1 adjacent headers of
    one set of HEADER_VALS validators of power 100, every one signing.
    Returns the set's and each (header, commit)'s wire bytes."""
    pubs = pool.map(_header_pub, range(HEADER_VALS))
    vset = ValidatorSet.new([Validator.new(ed25519.PubKey(p), 100) for p in pubs])
    key_of = {p: i for i, p in enumerate(pubs)}
    order = [key_of[v.pub_key.bytes()] for v in vset.validators]
    headers, jobs = [], []
    prev = b"\x00" * 32
    for h in range(1, HEADERS + 2):
        ts = canonical.Timestamp(HEADER_T0 + h, 0)
        hdr = Header(
            version=Version(block=11, app=0), chain_id=HEADER_CHAIN, height=h, time=ts,
            last_block_id=BlockID(prev, PartSetHeader(1, prev)) if h > 1 else BlockID(),
            validators_hash=vset.hash(), next_validators_hash=vset.hash(),
            consensus_hash=b"\x01" * 32, app_hash=b"",
            proposer_address=vset.validators[0].address,
        )
        prev = hdr.hash()
        bid = BlockID(prev, PartSetHeader(1, prev))
        tpl = canonical.canonical_vote_template(
            chain_id=HEADER_CHAIN, msg_type=canonical.SIGNED_MSG_TYPE_PRECOMMIT, height=h,
            round_=0, block_id=bid.canonical())
        msg = canonical.compose_vote_sign_bytes(tpl, ts)
        jobs += [(i, msg) for i in order]
        headers.append((hdr, bid, ts))
    sigs = pool.map(_header_sign, jobs, chunksize=256)
    chain = []
    for k, (hdr, bid, ts) in enumerate(headers):
        row = sigs[k * HEADER_VALS : (k + 1) * HEADER_VALS]
        commit = Commit(hdr.height, 0, bid, [CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts, sig)
                                             for v, sig in zip(vset.validators, row)])
        chain.append((hdr.encode(), commit.encode()))
    return vset.encode(), chain


def _headers_from_wire(header_wire: tuple, tamper_at=None) -> tuple:
    """(trusted signed header, [(signed header, set)]) decoded from the
    wire; tamper_at = (height, index) flips that signature first."""
    vbytes, chain = header_wire
    vset = ValidatorSet.decode(vbytes)
    shs = []
    for hb, cb in chain:
        commit = Commit.decode(cb)
        if tamper_at is not None and commit.height == tamper_at[0]:
            sigs = list(commit.signatures)
            cs = sigs[tamper_at[1]]
            sigs[tamper_at[1]] = dataclasses.replace(cs, signature=tamper(cs.signature))
            commit = Commit.decode(Commit(commit.height, commit.round, commit.block_id,
                                          sigs).encode())
        shs.append(SignedHeader(Header.decode(hb), commit))
    return shs[0], [(sh, vset) for sh in shs[1:]]


def _overlap(trace_name: str) -> dict:
    """From a kept trace: the host-to-device copies and the kernels (their
    streams), and how many copies ran while a kernel ran."""
    with open(TRACE_DIR / f"{trace_name}.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]

    def iv(e):
        return e["ts"], e["ts"] + e["dur"]

    overlapped, overlap_us = 0, 0.0
    for c in h2d:
        a, b = iv(c)
        cut = sum(max(0.0, min(b, y) - max(a, x)) for x, y in map(iv, kern))
        overlapped += cut > 0
        overlap_us += cut
    return {
        "h2d_copies": len(h2d),
        "kernels": len(kern),
        "h2d_streams": sorted({e.get("args", {}).get("stream") for e in h2d}, key=str),
        "kernel_streams": sorted({e.get("args", {}).get("stream") for e in kern}, key=str),
        "h2d_copies_overlapping_a_kernel": overlapped,
        "h2d_overlap_ms": overlap_us / 1e3,
    }


def dispatcher_phase(vals, commit, ents: list, light_wire: dict, header_wire: tuple,
                     dev) -> dict:
    """Slice (f): the asynchronous dispatcher on the card. Returns its
    checks' numbers and the launches of config #5's first run."""
    out = {}

    def vc(c, fn=validation.verify_commit):
        return lambda: fn(CHAIN_ID, vals, BLOCK, HEIGHT, c, device=dev)

    bad, bad_msg, low, low_msg = _commits(vals, commit)
    # (f1) verify_commit through the dispatcher: cold and warm, both paths
    wants = {
        None: ({"k1_rlc": 1, "k2_rlc": 1, "k3_rlc": 1},
               {"k1_rlc_cached": 1, "k2_rlc": 1, "k3_rlc": 1}),
        "0": ({"k1_decompress": 1, "k2_table": 1, "k3_ladder": 1},
              {"k1_decompress_cached": 1, "k2_table": 1, "k3_ladder": 1}),
    }
    with launch_threads() as launchers:
        for flag, (cold, warm) in wants.items():
            with env("TM_TPU_RLC", flag):
                epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
                per_call = []
                for _ in range(3):
                    before = dict(kernels.LAUNCHES)
                    vc(commit)()
                    per_call.append(_launched(before))
                check(per_call == [cold, dict(warm, epoch_coords=1), warm],
                      f"(f1) TM_TPU_RLC={flag}: three calls launched {per_call}")
                before = dict(kernels.LAUNCHES)
                expect_error(vc(bad), ValueError, bad_msg)
                check(_launched(before) == warm, f"(f1) the tampered call launched "
                      f"{_launched(before)}")
                expect_error(vc(low), ErrNotEnoughVotingPowerSigned, low_msg)
                epoch_cache.reset(depth=0)
                expect_error(vc(bad), ValueError, bad_msg)
                log(f"slice (f1): TM_TPU_RLC={flag} through the dispatcher: launches per call "
                    f"{per_call}; tampered #{TAMPER_AT} blamed warm and cold; low power "
                    "rejected")
    check_dispatcher_launched(launchers, dev, "slice (f1)")

    # (f2) four callers at once on one warm set
    with env("TM_TPU_RLC", None):
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        for _ in range(2):
            vc(commit)()
        results = [None] * CONCURRENT
        kernels.reset_launches()

        def caller(k):
            try:
                vc(commit)()
            except Exception as e:  # the caller's outcome, checked below
                results[k] = e

        threads = [threading.Thread(target=caller, args=(k,)) for k in range(CONCURRENT)]
        with launch_threads() as launchers:
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            conc_ms = (time.perf_counter() - t) * 1e3
        check(not any(th.is_alive() for th in threads), "(f2) a caller did not return")
        check(results == [None] * CONCURRENT, f"(f2) the concurrent callers raised {results}")
        conc = _launched({})
        check_dispatcher_launched(launchers, dev, "slice (f2)")
        out["concurrent"] = {"callers": CONCURRENT, "launches": conc, "wall_ms": conc_ms}
        log(f"slice (f2): {CONCURRENT} concurrent verify_commit calls returned None in "
            f"{conc_ms:.1f} ms; launches {conc} (k3_rlc below {CONCURRENT} is coalescing)")

    # (f3) BASELINE.json config #5: pipelined adjacent headers
    n_headers = len(header_wire[1]) - 1
    with env("TM_TPU_RLC", None):
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        trusted, headers = _headers_from_wire(header_wire)

        def run_headers(hs=headers):
            pipeline.verify_headers_pipelined(HEADER_CHAIN, trusted, hs, device=dev)

        kernels.reset_launches()
        with launch_threads() as launchers:
            t = time.perf_counter()
            run_headers()
            first_ms = (time.perf_counter() - t) * 1e3
        header_launches = _launched({})
        check_dispatcher_launched(launchers, dev, "slice (f3)")
        n_sigs = sum(early_stop(sh.commit, vs, 2, 3) for sh, vs in headers)
        batches = -(-n_sigs // backend.BUCKETS[-1])
        # the dispatcher may fuse queued batches of one set (up to
        # rlc.MAX_SIGS), so the launches are at most the batches
        check(1 <= header_launches.get("k3_rlc", 0) <= batches,
              f"(f3) {n_sigs} signatures in {batches} batches launched {header_launches}")
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            run_headers()
            runs.append((time.perf_counter() - t) * 1e3)
        prof = traced_calls("verify_headers_pipelined", [run_headers], "headers_pipelined",
                            warm=run_headers)[0]
        # the same range one header at a time, the commit checks alone
        t = time.perf_counter()
        for sh, vs in headers:
            validation.verify_commit_light(HEADER_CHAIN, vs, sh.commit.block_id,
                                           sh.header.height, sh.commit, device=dev)
        seq_ms = (time.perf_counter() - t) * 1e3
        ov = _overlap("headers_pipelined")
        med = statistics.median(runs)
        # the tampered copy, blamed as a sequential loop blames it
        ht, hi = HEADER_TAMPER
        trusted_b, bad_headers = _headers_from_wire(header_wire, (ht, hi))
        seq = None
        for sh, vs in bad_headers:
            try:
                validation.verify_commit_light(HEADER_CHAIN, vs, sh.commit.block_id,
                                               sh.header.height, sh.commit, device=dev)
            except ValueError as e:
                seq = (sh.header.height, str(e))
                break
        check(seq is not None and seq[0] == ht, f"(f3) the sequential loop found {seq}")
        m = re.match(r"wrong signature \(#(\d+)\): ", seq[1])
        check(m is not None, f"(f3) the sequential error {seq[1]:.80}")
        expect_error(lambda: pipeline.verify_headers_pipelined(
            HEADER_CHAIN, trusted_b, bad_headers, device=dev), ValueError,
            f"header {ht}: wrong signature (entry {m.group(1)})")
        out["headers"] = {
            "headers": n_headers, "validators": HEADER_VALS, "signatures": n_sigs,
            "batches": batches, "launches": header_launches, "first_ms": first_ms,
            "runs_ms": runs, "median_ms": med, "headers_per_s": n_headers / (med / 1e3),
            "sequential_ms": seq_ms, "sequential_headers_per_s": n_headers / (seq_ms / 1e3),
            "profiled_call_ms": prof["call_ms"], "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": 1 - prof["device_busy_ms"] / prof["call_ms"],
            "device_events": prof["device_events"], "spans_ms": prof["spans_ms"],
            "overlap": ov, "tampered": {"height": ht, "entry": int(m.group(1))},
        }
        log(f"slice (f3): verify_headers_pipelined over {n_headers} headers of {HEADER_VALS} "
            f"validators: {n_sigs} signatures in {batches} batches, launches "
            f"{header_launches}; first run {first_ms:.1f} ms, then median {med:.1f} ms "
            f"({n_headers / (med / 1e3):.0f} headers/s; one verify_commit_light a header in "
            f"turn {seq_ms:.1f} ms, {n_headers / (seq_ms / 1e3):.0f} headers/s); traced run "
            f"{prof['call_ms']:.1f} ms, "
            f"device busy {prof['device_busy_ms']:.3f} ms, idle "
            f"{out['headers']['device_idle_share']:.1%}; copies and kernels {ov}; the "
            f"signature tampered at {ht}/{hi} blamed as entry {m.group(1)}, as the sequential "
            "loop blames it")

    # (f4) the light service over slice (e)'s chain
    with env("TM_TPU_RLC", None):
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        blocks = {h: convert.light_block_from_wire(*w) for h, w in light_wire.items()}

        def tampered2(sigs):
            sigs[LIGHT_INSIDE] = dataclasses.replace(
                sigs[LIGHT_INSIDE], signature=tamper(sigs[LIGHT_INSIDE].signature))

        forged = _rewired(blocks[2], tampered2)
        pairs = [(1, blocks[2]), (1, blocks[10]), (1, blocks[17]), (1, forged)]
        reqs = [light_batch.HeaderRequest(blocks[t].signed_header, blocks[t].validators,
                                          u.signed_header, u.validators, LIGHT_PERIOD,
                                          LIGHT_DRIFT, now=LIGHT_NOW) for t, u in pairs]
        want = []
        for i, r in enumerate(reqs):
            try:
                light_verifier.verify(r.trusted_header, r.trusted_vals, r.untrusted_header,
                                      r.untrusted_vals, r.trusting_period, r.now,
                                      r.max_clock_drift, r.trust_level, device=dev)
                err = None
            except Exception as e:  # the sequential outcome is the expectation
                err = e
            want.append({"index": i, "height": str(r.untrusted_header.header.height),
                         "ok": err is None, "error": None if err is None else str(err),
                         "error_type": None if err is None else type(err).__name__})
        svc = light_service.LightVerifyService(device=dev)
        try:
            kernels.reset_launches()
            t = time.perf_counter()
            got = svc.submit_many(reqs).results(timeout=300)
            svc_ms = (time.perf_counter() - t) * 1e3
            svc_launches = _launched({})
        finally:
            svc.close()
        check(got == want, f"(f4) the light service gave {got}, the sequential verifier {want}")
        check([v["ok"] for v in got] == [True, True, False, False], f"(f4) verdicts {got}")
        out["light_service"] = {"requests": len(reqs), "ms": svc_ms, "launches": svc_launches,
                                "verdicts": [(v["ok"], v["error_type"]) for v in got]}
        log(f"slice (f4): the light service's {len(reqs)} verdicts (1 -> 2, 1 -> 10, 1 -> 17, "
            f"1 -> 2 tampered) equal the sequential verifier's: "
            f"{[(v['ok'], v['error_type']) for v in got]}; {svc_ms:.1f} ms, launches "
            f"{svc_launches}")

    # (f5) owned verdicts: the first three batches' arrays survive eight more
    v = pipeline.shared_verifier(dev)
    with env("TM_TPU_RLC", None):
        n = min(1024, len(ents))
        rows = []

        def batch(k):
            sub = list(ents[:n])
            at = (37 * k) % n
            p, m_, sg = sub[at]
            sub[at] = (p, m_, tamper(sg))
            want_row = np.ones(n, bool)
            want_row[at] = False
            return want_row, v.submit(EntryBlock.from_entries(sub)).result(timeout=120)

        held = [batch(k) for k in range(3)]
        for k in range(3, 11):
            rows.append(batch(k))
        for want_row, got_row in held + rows:
            check(got_row.tolist() == want_row.tolist(), "(f5) a verdict row is wrong")
        check(all(got_row.flags.owndata for _, got_row in held), "(f5) a verdict is a view")
        check(v._pool.hits >= 8, f"(f5) the buffers were not reused (hits {v._pool.hits})")
        log(f"slice (f5): the first three batches' verdicts unchanged after eight more of the "
            f"same layout (pool hits {v._pool.hits}, misses {v._pool.misses})")

    # (f6) a batch whose host prep fails fails alone
    with env("TM_TPU_RLC", None):
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        epoch_cache.note_valset(vals)
        key = epoch_cache.note_valset(vals)
        n = min(256, len(ents))
        poisoned = EntryBlock.from_entries(ents[:n])
        poisoned.val_idx = np.full(n, 10 ** 6, dtype=np.int32)
        poisoned.epoch_key = key
        fut = v.submit(poisoned)
        try:
            fut.result(timeout=120)
            check(False, "(f6) the poisoned batch resolved")
        except pipeline.DispatchError as e:
            check("batch prep failed" in str(e) and isinstance(e.__cause__, ValueError),
                  f"(f6) the poisoned batch failed with {e!r}")
            poison_msg = str(e)
        after = v.submit(EntryBlock.from_entries(ents[:n])).result(timeout=120)
        check(after.all() and after.shape == (n,), "(f6) the next batch did not verify")
        log(f"slice (f6): a batch whose prep raised failed alone ({poison_msg:.100}); the next "
            "batch verified")
    check(v._dispatch_thread.is_alive() and v._resolve_thread.is_alive(),
          "the dispatcher's threads died")
    return out


# -- slice (g): the secp256k1 lane and config #4 ------------------------------


def _sign_secp_validator(i: int) -> tuple:
    """(pub33, timestamp, sig) of secp256k1 validator i's precommit for
    BLOCK (as _sign_validator)."""
    sk = _secp_sk(i)
    ts = canonical.Timestamp(T0_SECONDS, 1000 * i + 1)
    msg = canonical.compose_vote_sign_bytes(_vote_template(), ts)
    return sk.pub_key().bytes(), ts, sk.sign(msg)


def build_secp_commit(pool) -> tuple:
    """(ValidatorSet, Commit) of SECP_VALIDATORS secp256k1 validators of
    power SECP_POWER (bench.py schemes' set), all signing."""
    signed = pool.map(_sign_secp_validator, range(SECP_VALIDATORS), chunksize=64)
    vals = ValidatorSet.new([Validator.new(secp256k1.PubKey(pub), SECP_POWER)
                             for pub, _, _ in signed])
    by_pub = {pub: (ts, sig) for pub, ts, sig in signed}
    sigs = []
    for v in vals.validators:
        ts, sig = by_pub[v.pub_key.bytes()]
        sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts, sig))
    return vals, Commit(HEIGHT, ROUND, BLOCK, sigs)


def _mixed_sign(job: tuple) -> bytes:
    kind, i = job
    if kind == "ed25519":
        return ed25519.gen_priv_key(i.to_bytes(32, "little")).sign(b"mx-ed-%d" % i)
    if kind == "sr25519":
        return sr25519.gen_priv_key(b"\x09" * 32).sign(b"mx-sr-%d" % i)
    return _secp_sk(-1).sign(b"mx-secp-%d" % i)


def build_mixed(pool) -> list:
    """BASELINE.json config #4 as bench._bench_mixed_curve builds it:
    2,048 ed25519 signatures by distinct keys, 1,792 by one sr25519 key,
    256 by one secp256k1 key (a seeded key here; bench.py draws one),
    shuffled by random.Random(5). (PubKey, msg, sig) triples."""
    jobs = [(k, i) for k, n in zip(("ed25519", "sr25519", "secp256k1"), MIXED)
            for i in range(n)]
    sigs = pool.map(_mixed_sign, jobs, chunksize=32)
    sr_pk = sr25519.gen_priv_key(b"\x09" * 32).pub_key()
    secp_pk = _secp_sk(-1).pub_key()
    out = []
    for (kind, i), sig in zip(jobs, sigs):
        if kind == "ed25519":
            out.append((ed25519.gen_priv_key(i.to_bytes(32, "little")).pub_key(),
                        b"mx-ed-%d" % i, sig))
        elif kind == "sr25519":
            out.append((sr_pk, b"mx-sr-%d" % i, sig))
        else:
            out.append((secp_pk, b"mx-secp-%d" % i, sig))
    random.Random(5).shuffle(out)
    return out


def _secp_oracle(entry: tuple) -> bool:
    pub, msg, sig = entry
    return len(pub) == 33 and secp256k1.PubKey(pub).verify_signature(msg, sig)


def secp_kernel_inputs(commit_ents: list, edge: list, n: int) -> tuple:
    """The uncached kernel's arrays for n rows: the edge battery, the two
    crafted rows of secp_wrap_rows, commit signatures with one tampered,
    and 3 padding rows (at 16 rows: the battery, the crafted rows and
    one padding row); the expected verdicts (the battery's from the
    oracle, the commit rows known: signed, one tampered); the items."""
    body = list(commit_ents[: max(n - len(edge) - 2 - 3, 0)])
    if body:
        pk, msg, sig = body[len(body) // 2]
        body[len(body) // 2] = (pk, msg, tamper(sig))
    items = edge + [edge[0], edge[0]] + body  # the crafted rows' items are overwritten
    args = list(secp_verify.prepare_rows(items, n))
    at = slice(len(edge), len(edge) + 2)
    for a, w in zip(args, secp_wrap_rows()):
        a[at] = w
    want = np.ones(n, dtype=bool)
    want[: len(edge)] = [_secp_oracle(e) for e in edge]
    want[len(edge) + 1] = False
    if body:
        want[len(edge) + 2 + len(body) // 2] = False
    return args, want, items


def secp_kernel_phase(stats: dict, commit_ents: list, table_pub: np.ndarray, dev) -> dict:
    """Both secp256k1 kernels against their plain versions on the card at
    SECP_SHAPES rows, verdicts and canonical final coordinates exactly,
    the verdicts against the expected ones. The cached kernel reads a
    table of table_pub's keys (the battery's and the set's) in shuffled
    order. Returns the edge battery's oracle verdicts."""
    edge = secp_edge_entries()
    oracle = [_secp_oracle(e) for e in edge]
    order = np.random.default_rng(SEED).permutation(len(table_pub))
    ep = epoch_cache.EpochEntry(b"smoke secp table", table_pub[order], scheme="secp256k1")
    tables = ep.secp_tables(dev)
    where = {table_pub[j].tobytes(): k for k, j in enumerate(order)}
    for n in SECP_SHAPES:
        args, want, items = secp_kernel_inputs(commit_ents, edge, n)
        t = [torch.from_numpy(a).to(dev) for a in args]
        label = f"{n} secp256k1 rows"
        out, _ = hold(stats, "secp_verify", label,
                      lambda: secp_verify.verify_plain(*t, want_xyz=True),
                      lambda: secp_verify.secp_verify(*t, want_xyz=True))
        got = out.cpu().numpy()
        check(bool((got == want).all()), f"secp256k1 verdicts at {label} differ from the "
              f"expected at {np.nonzero(got != want)[0][:8].tolist()}")
        # the cached kernel: the same signatures, keys from the table
        crafted = (len(edge), len(edge) + 1)
        real = [i for i in range(len(items)) if i not in crafted]
        vidx = np.array([where[items[i][0]] for i in real], dtype=np.int32)
        cargs = secp_verify.prepare_rows_cached([items[i] for i in real], vidx, n, ep.vp - 1,
                                                ep.n_vals)
        ct = [torch.from_numpy(a).to(dev) for a in cargs]
        cout, _ = hold(stats, "secp_verify_cached", label,
                       lambda: secp_verify.verify_cached_plain(*tables, *ct, want_xyz=True),
                       lambda: secp_verify.secp_verify_cached(*tables, *ct, want_xyz=True))
        cwant = np.ones(n, dtype=bool)
        cwant[: len(real)] = [want[i] for i in real]
        cgot = cout.cpu().numpy()
        check(bool((cgot == cwant).all()), f"cached secp256k1 verdicts at {label} differ at "
              f"{np.nonzero(cgot != cwant)[0][:8].tolist()}")
        log(f"kernels: {label}: cold and warm verdicts as expected, {int((~got).sum())} reject "
            f"cold, {int((~cgot).sum())} warm")
    check(oracle == [True] * 4 + [False] * (len(edge) - 4),
          f"the secp256k1 battery's oracle verdicts {oracle}")
    return {"battery": oracle}


def _light_call(vals, commit, dev) -> tuple:
    """prepare_commit_light -> the shared dispatcher -> conclude: (the
    batch size, the launches of the call)."""
    before = dict(kernels.LAUNCHES)
    entries, conclude = validation.prepare_commit_light(CHAIN_ID, vals, BLOCK, HEIGHT, commit)
    conclude(pipeline.shared_verifier(dev).submit(entries).result(timeout=600))
    return len(entries), _launched(before)


def _secp_commits(vals, commit) -> tuple:
    """(tampered at TAMPER_AT, its message, tampered past the light stop,
    below 2/3, its message)."""
    bad, bad_msg, low, low_msg = _commits(vals, commit)
    late = Commit(commit.height, commit.round, commit.block_id, list(commit.signatures))
    cs = late.signatures[SECP_LATE_TAMPER]
    late.signatures[SECP_LATE_TAMPER] = dataclasses.replace(cs, signature=tamper(cs.signature))
    return bad, bad_msg, late, low, low_msg


def secp_phase(vals, commit, mixed_ents: list, ed_ents: list, battery: list, dev) -> dict:
    """Slice (g) on the card: (g1) the secp256k1 commit through the light
    path's prepare seam and the dispatcher, cold and warm; (g2) config
    #4 through verify_mixed; (g3) Secp256k1DeviceBatchVerifier and
    backend.verify_batch over the battery; (g4) an ed25519 and a
    secp256k1 block submitted at once while the card is busy. Returns the
    checks' numbers and the launches of each of (g1)-(g4), counted from 0
    at the start of (g1)."""
    out, by_slice = {}, {}
    bad, bad_msg, late, low, low_msg = _secp_commits(vals, commit)
    needed = vals.total_voting_power() * 2 // 3
    stop = needed // SECP_POWER + 1
    with launch_threads() as launchers:
        epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
        kernels.reset_launches()
        n_cold, cold = _light_call(vals, commit, dev)
        n_warm, warm = _light_call(vals, commit, dev)
        check((n_cold, n_warm) == (stop, stop) == (SECP_LIGHT_STOP, SECP_LIGHT_STOP),
              f"(g1) batches of {n_cold} and {n_warm} signatures, wanted {SECP_LIGHT_STOP}")
        check((cold, warm) == ({"secp_verify": 1}, {"secp_verify_cached": 1}),
              f"(g1) the cold and warm calls launched {cold}, {warm}")
        before = dict(kernels.LAUNCHES)
        expect_error(lambda: _light_call(vals, bad, dev), ValueError, bad_msg)
        check(_launched(before) == {"secp_verify_cached": 1}, "(g1) the tampered commit did "
              "not run warm")
        _, late_l = _light_call(vals, late, dev)
        check(late_l == {"secp_verify_cached": 1}, f"(g1) the late tamper launched {late_l}")
        before = dict(kernels.LAUNCHES)
        expect_error(lambda: _light_call(vals, low, dev), ErrNotEnoughVotingPowerSigned, low_msg)
        check(_launched(before) == {}, "(g1) the low-power commit launched a kernel")
        epoch_cache.reset(depth=0)
        before = dict(kernels.LAUNCHES)
        expect_error(lambda: _light_call(vals, bad, dev), ValueError, bad_msg)
        check(_launched(before) == {"secp_verify": 1}, "(g1) the tampered commit did not run "
              "cold")
        by_slice["g1"] = _launched({})
        log(f"slice (g1): {SECP_VALIDATORS}-validator secp256k1 commit, {n_cold} signatures to "
            f"the light stop; cold {cold}, warm {warm}; tampered #{TAMPER_AT} blamed warm and "
            f"cold, tampered #{SECP_LATE_TAMPER} (past the stop) accepted, low power rejected")
    check_dispatcher_launched(launchers, dev, "slice (g1)")

    # (g2) config #4
    tampered = list(mixed_ents)
    bad_rows = []
    for kind in ("ed25519", "sr25519", "secp256k1"):
        i = next(j for j, e in enumerate(tampered) if e[0].type() == kind)
        pk, msg, sig = tampered[i]
        tampered[i] = (pk, msg, sig[:63] + bytes([sig[63] ^ 1]))
        bad_rows.append(i)
    epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    g2_start = before = dict(kernels.LAUNCHES)
    res = mixed.verify_mixed(mixed_ents, device=dev)
    lane_l = _launched(before)
    check(all(res) and len(res) == sum(MIXED), "(g2) the clean config #4 batch did not verify")
    want_l = {"k1_rlc": 1, "k2_rlc": 1, "k3_rlc": 1, "k1r_decode": 1, "k2_table": 1,
              "k3r_ladder": 1, "secp_verify": 1}
    check(lane_l == want_l, f"(g2) verify_mixed launched {lane_l}, wanted {want_l}")
    res = mixed.verify_mixed(tampered, device=dev)
    falses = [i for i, r in enumerate(res) if not r]
    check(falses == sorted(bad_rows), f"(g2) rejected rows {falses[:8]}, wanted {bad_rows}")
    runs = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        mixed.verify_mixed(mixed_ents, device=dev)
        runs.append((time.perf_counter() - t) * 1e3)
    out["mixed"] = dict(_run_stats(runs), sigs_per_s=sum(MIXED) / statistics.median(runs) * 1e3,
                        launches=lane_l)
    by_slice["g2"] = _launched(g2_start)
    log(f"slice (g2): config #4 ({'+'.join(map(str, MIXED))}) through verify_mixed launched "
        f"{lane_l}; the three tampered rows {sorted(bad_rows)} rejected alone; median "
        f"{out['mixed']['median_ms']:.2f} ms over {REPEATS} (min {min(runs):.2f}, max "
        f"{max(runs):.2f}), {out['mixed']['sigs_per_s']:.0f} signatures/s")

    # (g3) the secp256k1 batch verifier and the synchronous backend path
    items = [e for e, _ in zip(secp_edge_entries(), battery) if len(e[2]) == 64]
    want = [ok for e, ok in zip(secp_edge_entries(), battery) if len(e[2]) == 64]
    bv = mixed.Secp256k1DeviceBatchVerifier(device=dev)
    for pub, msg, sig in items:
        bv.add(secp256k1.PubKey(pub), msg, sig)
    before = dict(kernels.LAUNCHES)
    check(bv.verify() == (False, want), "(g3) Secp256k1DeviceBatchVerifier differs")
    got = backend.verify_batch(EntryBlock.from_entries(items, scheme="secp256k1"), device=dev)
    check(got.tolist() == want, "(g3) backend.verify_batch differs from the oracle")
    by_slice["g3"] = _launched(before)
    check(by_slice["g3"] == {"secp_verify": 2}, f"(g3) launched {by_slice['g3']}")
    log(f"slice (g3): Secp256k1DeviceBatchVerifier and backend.verify_batch over the "
        f"{len(items)}-entry battery equal the oracle")

    # (g4) an ed25519 and a secp256k1 block, both uncached, at once
    prepared = []

    def recording(entries):
        prepared.append((entries.scheme, len(entries)))
        return backend.prepare_block(entries)

    busy_ents = commit_entries(commit, vals)
    busy = EntryBlock.from_entries(busy_ents, scheme="secp256k1")
    ed_block = EntryBlock.from_entries(ed_ents[:G4_ED])
    ed_want = np.ones(G4_ED, dtype=bool)
    secp_block = EntryBlock.from_entries(items, scheme="secp256k1")
    v = pipeline.AsyncBatchVerifier(dev, prepare=recording)
    before = dict(kernels.LAUNCHES)
    try:
        futs = [v.submit(busy), v.submit(ed_block), v.submit(secp_block)]
        got = [f.result(timeout=600) for f in futs]
    finally:
        v.close()
    by_slice["g4"] = _launched(before)
    check(got[0].all() and got[1].tolist() == ed_want.tolist() and got[2].tolist() == want,
          "(g4) a job's verdicts are wrong")
    check([p for p in prepared if p[0] == "ed25519"] == [("ed25519", G4_ED)]
          and sum(n for s, n in prepared if s == "secp256k1") == len(busy) + len(items),
          f"(g4) prepared batches {prepared}")
    out["g4_prepared"] = prepared
    log(f"slice (g4): batches prepared {prepared}: the ed25519 block never fused with a "
        "secp256k1 one; each job's verdicts right")
    return out, by_slice


SECP_STAGES = ("commit.select", "commit.sign_bytes", "pipeline.prep", "secp.prep",
               "pipeline.h2d", "secp.gather", "secp.kernels", "pipeline.d2h",
               "pipeline.resolve")


def secp_timing(vals, commit, dev) -> dict:
    """(g1)'s warm call timed: REPEATS calls (median, min, max), then
    PROFILED calls traced for the stages and the card's busy time."""
    epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)

    def call():
        _light_call(vals, commit, dev)

    call()
    call()
    runs = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        call()
        runs.append((time.perf_counter() - t) * 1e3)
    prof = traced_calls("secp_light", [call] * PROFILED, "secp_light", warm=call)
    stages = {s: statistics.median(p["spans_ms"].get(s, 0.0) for p in prof) for s in SECP_STAGES}
    prof_ms = statistics.median(p["call_ms"] for p in prof)
    busy = idle = None
    if sum(sum(p["device_events"].values()) for p in prof):
        busy = statistics.median(p["device_busy_ms"] for p in prof)
        idle = statistics.median(1 - p["device_busy_ms"] / p["call_ms"] for p in prof)
    out = dict(_run_stats(runs), profiled_call_ms=prof_ms, stages_ms=stages,
               device_busy_ms=busy, device_idle_share=idle,
               device_events=prof[0]["device_events"],
               sigs_per_s=SECP_LIGHT_STOP / statistics.median(runs) * 1e3)
    log(f"timing [secp256k1 light, warm]: median {out['median_ms']:.2f} ms over {REPEATS} "
        f"(min {min(runs):.2f}, max {max(runs):.2f}); {PROFILED} profiled calls, median "
        f"{prof_ms:.2f} ms; stages (median ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + (f"; device busy {busy:.3f} ms, idle {idle:.1%}" if busy is not None
           else "; the trace holds no device events: busy and idle not measured"))
    return out


def secp_products() -> dict:
    """The multiplies, squarings and small-constant multiplies (by
    constant) of one row of the plain secp256k1 ladder, counted on the
    CPU: they must equal the source's (SECP_OPS), so an operation the
    count misses cannot lower the bound without an error."""
    from tendermint_tpu_torch.ops import fe_secp

    counts = dict.fromkeys(SECP_OPS, 0)
    real_mul, real_sq, real_small = fe_secp.mul, fe_secp.sq, fe_secp.mul_small

    def mul(a, b):
        counts["mul"] += 1
        return real_mul(a, b)

    def sq(a):
        counts["sq"] += 1
        return real_mul(a, a)

    def mul_small(a, k):
        counts[f"x{k}"] += 1
        return real_small(a, k)

    args = [torch.from_numpy(a) for a in secp_verify.prepare_rows([], 1)]
    fe_secp.mul, fe_secp.sq, fe_secp.mul_small = mul, sq, mul_small
    try:
        secp_verify.verify_plain(*args)
    finally:
        fe_secp.mul, fe_secp.sq, fe_secp.mul_small = real_mul, real_sq, real_small
    check(counts == SECP_OPS, f"the plain secp256k1 ladder forms {counts} a row, "
          f"the source states {SECP_OPS}")
    return counts


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


def product_slots() -> tuple:
    """(a field multiply, a squaring) in 32-bit multiply-add slots, each at
    the cheaper of its formulations: PRODUCTS_MUL / PRODUCTS_SQ on the
    13-bit limbs, or WIDE_MUL / WIDE_SQ's 32 x 32 -> 64 products at
    INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK slots each and their 32-bit
    multiplies."""
    wide = INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK
    return (min(PRODUCTS_MUL, wide * WIDE_MUL[0] + WIDE_MUL[1]),
            min(PRODUCTS_SQ, wide * WIDE_SQ[0] + WIDE_SQ[1]))


def wide_multiplies() -> dict:
    """Multiplies a point of decompress_wide: 32 x 32 -> 64 products
    (`wide`), 32-bit multiplies (`int32`, with the multiply-adds of its
    13-bit products) and the 32-bit multiply-add slots the bound counts
    (`slots`, INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK a wide product, its
    13-bit products at product_slots). The chain's squarings and
    multiplies are counted by running fe.pow22523 (the same chain) on one
    column; the rest is as WIDE_* state. The counts must equal the ones
    stated in the sources' headers (WIDE_PER_POINT)."""
    n_mul, n_sq = _count_mul_sq(lambda: fe.pow22523(fe.from_ints([2])))
    n_sq += WIDE_AROUND_CHAIN[0]
    n_mul += WIDE_AROUND_CHAIN[1]
    wide = n_sq * WIDE_SQ[0] + n_mul * WIDE_MUL[0]
    int32 = n_sq * WIDE_SQ[1] + n_mul * WIDE_MUL[1]
    adds13 = WIDE_13BIT[0] * PRODUCTS_SQ + WIDE_13BIT[1] * PRODUCTS_MUL
    check((wide, int32 + adds13) == WIDE_PER_POINT, f"decompress_wide's multiplies a point "
          f"{(wide, int32 + adds13)}, the sources state {WIDE_PER_POINT}")
    mul_slots, sq_slots = product_slots()
    return {"squarings": n_sq, "multiplies": n_mul, "wide": wide, "int32": int32 + adds13,
            "slots": (INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK * wide + int32
                      + WIDE_13BIT[0] * sq_slots + WIDE_13BIT[1] * mul_slots)}


def og_kernel_products() -> dict:
    """The products one signature of og_verify (or og_verify_cached) forms
    in the kernel, a quad of threads (OG_QUAD_OPS, OG_AROUND_CHAIN):
    squarings and multiplies a thread, 32 x 32 -> 64 products (`wide`) and
    32-bit multiplies (`int32`) a signature, and their multiply-add slots.
    pow22523's chain is counted by running fe.pow22523 on one column."""
    n_mul, n_sq = _count_mul_sq(lambda: fe.pow22523(fe.from_ints([2])))
    n_sq += OG_AROUND_CHAIN[0] + OG_QUAD_OPS["double"]
    n_mul += (OG_AROUND_CHAIN[1] + OG_QUAD_OPS["double"] + 2 * OG_QUAD_OPS["add_niels"]
              + 3 * OG_QUAD_OPS["add"] + OG_QUAD_OPS["to_niels"])
    wide = 4 * (n_sq * WIDE_SQ[0] + n_mul * WIDE_MUL[0])
    int32 = 4 * (n_sq * WIDE_SQ[1] + n_mul * WIDE_MUL[1])
    return {"squarings": n_sq, "multiplies": n_mul, "wide": wide, "int32": int32,
            "slots": INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK * wide + int32}


def sha_fold_mod_l(x: int) -> tuple:
    """x mod L for a 512-bit digest x as a kernel on 32-bit words would
    reduce it, the least work sha512_challenge's bound counts: three folds
    of 2^252 = -SHA_C (mod L), each splitting r = lo + 2^252 hi (hi of
    SHA_FOLD_WORDS words, checked) and forming lo - SHA_C hi, then one
    conditional add and one conditional subtract of L. Returns (x mod L,
    32 x 32 -> 64 products, other 32-bit operations): the digest's 16
    halves byte-swapped (PRMT); a fold's hi split out by funnel shifts (a
    word each), the subtraction over the product's words and lo's top
    word masked; a correction an add or subtract and a select a word."""
    wide, ops, r = 0, 16, x
    for words in SHA_FOLD_WORDS:
        hi = r >> 252
        check(-(1 << (32 * words - 1)) <= hi < 1 << (32 * words),
              f"a fold's high part {hi} exceeds {words} words")
        r = r - (hi << 252) - SHA_C * hi
        wide += SHA_C_WORDS * words
        ops += words + (SHA_C_WORDS + words) + 1
    check(-_edwards.L < r < 2 * _edwards.L, "three folds left r outside (-L, 2L)")
    r = r + _edwards.L if r < 0 else r
    r = r - _edwards.L if r >= _edwards.L else r
    return r, wide, ops + 2 * 16


def count_products(units: dict) -> dict:
    """(multiplies, squarings) per unit of each kernel, counted by running
    the plain versions on one unit (a lane, a table row, a signature) on
    the CPU with fe.mul and fe.sq counted per column. Their 13-bit
    multiply-adds (400 a multiply, 210 a squaring) must equal the count
    stated in the kernel's source's header: a field product the count
    misses would otherwise lower the bound without an error. `units` maps
    a kernel to a thunk of its plain version."""
    counted = {name: _count_mul_sq(fn) for name, fn in units.items()}
    adds = {name: m * PRODUCTS_MUL + q * PRODUCTS_SQ for name, (m, q) in counted.items()}
    check(adds == PRODUCTS_PER_UNIT,
          f"multiply-adds per unit {adds}, the sources state {PRODUCTS_PER_UNIT}")
    return counted


def _one_unit_thunks(cold, warm, table, sig, warm_sig, sr, og_in) -> dict:
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
    oa, orr, os1, ok1, osok, oidx = (t[:1].cpu().contiguous() for t in og_in)
    return {
        "og_verify": lambda: og.og_verify_plain(oa, orr, os1, ok1, osok),
        "og_verify_cached": lambda: og.og_verify_cached_plain(ctbl, oktbl, oidx, orr, os1, ok1,
                                                              osok),
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


def kernel_trace_ms(fn, kernel: str, reps: int, trace_name: str) -> tuple:
    """(median ms, launches seen): the device time of the kernel whose
    name holds `kernel` (one launch of it a call of fn()), each launch's
    interval on the card from the kernel events of a torch.profiler trace
    of reps calls (kept as build/traces/<trace_name>.json). A trace late
    in a long run has held only some of the launches (3 of 10 once), so
    sessions repeat, up to 5, until reps launches were seen; fails when
    none was."""
    fn()
    torch.cuda.synchronize()
    durs = []
    for _ in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        trace = TRACE_DIR / f"{trace_name}.json"
        prof.export_chrome_trace(str(trace))
        with open(trace) as f:
            durs += [e["dur"] / 1e3 for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "kernel" and kernel in e["name"]]
        if len(durs) >= reps:
            break
    check(bool(durs), f"no trace of {reps} calls holds a {kernel} launch")
    return statistics.median(durs), len(durs)


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


def traced_calls(name: str, fns: list, trace_name: str, warm=None) -> list:
    """Each fn() once inside a record_function(name) span, all under one
    torch.profiler trace (kept as build/traces/<trace_name>.json). Per
    call: its wall ms, the ms of each of the port's spans inside it by
    name, its device events by category, and the union of the card's
    kernel and copy intervals inside it. warm(), outside the spans, runs
    first: the dispatcher started anew makes its buffers on first use."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # the dispatcher's spans run on its threads: the profiler traces every
    # thread started after it, so the device's dispatcher starts anew inside
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=acts, experimental_config=cfg) as prof:
        pipeline.reset_shared()
        if warm is not None:
            warm()
        torch.cuda.synchronize()
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
    def call():
        validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, commit, device=dev)

    calls = traced_calls("verify_commit", [call] * PROFILED, f"verify_commit_{path}", warm=call)
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
    rlc_flag, pallas, host_hash, depth, key_type = PATH_SETUP[path]

    def call(c):
        validation.verify_commit(CHAIN_ID, vals, BLOCK, HEIGHT, c, device=dev)

    with env("TM_TPU_RLC", rlc_flag), env("TM_TPU_PALLAS", pallas), \
            env("TM_TPU_HOST_HASH", host_hash):
        epoch_cache.reset(depth=depth)
        for _ in range(2):  # the second call of a set is warm
            call(commit)
        calls = host_calls(lambda: call(commit))
        check(calls == HOST_CALLS[path],
              f"a {path} call made the host library calls {calls}, wanted {HOST_CALLS[path]}")
        if key_type == "ed25519":
            ram = fused_ram(lambda: call(commit))
            check(ram == [path in RAM_PATHS],
                  f"a {path} call's fused prep built RAM columns: {ram}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        e2e = []
        for _ in range(REPEATS):
            t = time.perf_counter()
            call(commit)
            e2e.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev)
        batch_runs = {}
        if key_type == "ed25519":
            # the batch stage alone, on the commit's selected signatures:
            # through the dispatcher, and the same prepare, launch and
            # conclude on the caller's thread (the synchronous composition)
            block, _ = validation.prepare_commit_batch(
                CHAIN_ID, vals, commit, vals.total_voting_power() * 2 // 3,
                validation._ignore_absent, validation._count_for_block, True, True)
            sync_fn = (og.verify_batch_og if pallas == "0" else verify.verify_batch_compact
                       if rlc_flag == "0" else rlc.verify_batch_rlc)
            v = pipeline.shared_verifier(dev)
            for name, fn in (("dispatched", lambda: v.submit(block).result(timeout=600)),
                             ("synchronous", lambda: sync_fn(block, device=dev))):
                check(bool(np.asarray(fn()).all()), f"the {path} batch stage ({name}) "
                      "rejected a valid signature")
                runs = batch_runs[name] = []
                for _ in range(REPEATS):
                    t = time.perf_counter()
                    fn()
                    runs.append(time.perf_counter() - t)
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
    batch_ms = {k: statistics.median(r) * 1e3 for k, r in batch_runs.items()}
    if batch_runs:
        log(f"timing [{path}]: the batch stage alone, median over {REPEATS} runs: "
            + ", ".join(f"{k} {batch_ms[k]:.2f} ms (min {min(r) * 1e3:.2f}, max "
                        f"{max(r) * 1e3:.2f})" for k, r in batch_runs.items()))
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
        "batch_stage_ms": batch_ms,
        "batch_stage_runs_ms": {k: [x * 1e3 for x in r] for k, r in batch_runs.items()},
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


def kernel_timing(vals, block: EntryBlock, sr_block: EntryBlock, secp_vals, secp_ents: list,
                  dev, sm_clock_hz: float) -> list:
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

    n_secp = secp_verify.bucket_for(len(secp_ents))
    sargs = [torch.from_numpy(a).to(dev) for a in secp_verify.prepare_rows(secp_ents, n_secp)]
    sout = secp_verify.secp_verify(*sargs)
    check(bool(sout[: len(secp_ents)].all().item()),
          "the secp256k1 commit's signatures did not all verify")
    sep = epoch_cache.EpochEntry(secp_vals.hash(), secp_vals.secp256k1_columns()[0],
                                 scheme="secp256k1")
    stables = sep.secp_tables(dev)
    scargs = [torch.from_numpy(a).to(dev) for a in secp_verify.prepare_rows_cached(
        secp_ents, np.arange(len(secp_ents), dtype=np.int32), n_secp, sep.vp - 1, sep.n_vals)]
    scout = secp_verify.secp_verify_cached(*stables, *scargs)
    check(bool(scout[: len(secp_ents)].all().item()),
          "the secp256k1 commit's signatures did not all verify warm")

    # the op-graph path at its bucket: k hashed on the card from the
    # R || A || M blocks, then the check, cold and over the set's table
    ob = og.prepare_batch(block, device_hash=True)
    n_og = ob.bucket
    oa, orr, osr_, ohi, olo, ocnt, osok = (torch.from_numpy(x).to(dev) for x in ob.args)
    ok_rows = og_sha.sha512_challenge(ohi, olo, ocnt)
    oout = og.og_verify(oa, orr, osr_, ok_rows, osok)
    check(bool(oout[: len(block)].all().item()), "the commit's signatures did not all verify "
          "on the op-graph path")
    oidx = torch.from_numpy(epoch_cache.table_columns(wblock, n_og, ep)).to(dev)
    ocout = og.og_verify_cached(ctbl, oktbl, oidx, orr, osr_, ok_rows, osok)
    check(bool(ocout[: len(block)].all().item()), "the commit's signatures did not all verify "
          "on the warm op-graph path")
    og_in = (oa, orr, osr_, ok_rows, osok, oidx)

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
        "secp_verify": (lambda: secp_verify.secp_verify(*sargs), tuple(sargs) + (sout,), n_secp),
        "secp_verify_cached": (lambda: secp_verify.secp_verify_cached(*stables, *scargs),
                               tuple(stables) + tuple(scargs) + (scout,), n_secp),
        "sha512_challenge": (lambda: og_sha.sha512_challenge(ohi, olo, ocnt),
                             (ohi, olo, ocnt, ok_rows), n_og),
        "og_verify": (lambda: og.og_verify(oa, orr, osr_, ok_rows, osok),
                      (oa, orr, osr_, ok_rows, osok, oout), n_og),
        "og_verify_cached": (
            lambda: og.og_verify_cached(ctbl, oktbl, oidx, orr, osr_, ok_rows, osok),
            (ctbl, oktbl, oidx, orr, osr_, ok_rows, osok, ocout), n_og),
    }
    counted = count_products(_one_unit_thunks(cold, warm, pub_t, sig, warm_sig, sr, og_in))
    products = {name: m * PRODUCTS_MUL + q * PRODUCTS_SQ for name, (m, q) in counted.items()}
    wide = wide_multiplies()
    mul_slots, sq_slots = product_slots()
    log(f"timing: a field multiply {mul_slots:.1f} and a squaring {sq_slots:.1f} multiply-add "
        f"slots (the cheaper formulation); decompress_wide a point: {wide['squarings']} "
        f"squarings and {wide['multiplies']} multiplies on the wide field, {wide['wide']} "
        f"32 x 32 -> 64 products and {wide['int32']} 32-bit multiplies, {wide['slots']:.0f} "
        f"slots")
    # the multiply-add slots a unit needs: each product of the plain
    # versions at the cheaper formulation; the cold K1s' and the table's
    # from their own formulation, whose 13-bit products priced the same way
    ops = {name: m * mul_slots + q * sq_slots for name, (m, q) in counted.items()}
    for name, points in WIDE_POINTS_PER_UNIT.items():
        ops[name] = wide["slots"] * points
    # the secp256k1 kernels: wide products only, counted from the plain
    # ladder (secp_products) as the source states them
    secp_counts = secp_products()
    log(f"timing: a secp256k1 row: {secp_counts}, {SECP_WIDE_PER_SIG} 32 x 32 -> 64 products")
    for name in ("secp_verify", "secp_verify_cached"):
        ops[name] = SECP_WIDE_PER_SIG * INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK
    # the op-graph checks: the kernels' own count beside the bound
    og_kernel = og_kernel_products()
    log(f"timing: og_verify{{,_cached}}: {og_kernel['wide']} 32 x 32 -> 64 products and "
        f"{og_kernel['int32']} 32-bit multiplies a signature in the kernel, "
        f"{og_kernel['slots']:.0f} slots; the plain version {counted['og_verify']} "
        f"(multiplies, squarings), {ops['og_verify']:.0f} slots")
    # the hash: the least 32-bit operations of the blocks this run's
    # messages use and of one reduction a message (the fold checked
    # exact on this run's digests); the source's count beside it
    blocks_used = int(ocnt.sum().item())
    digests = og_sha.sha512_blocks_plain(ohi.cpu(), olo.cpu(), ocnt.cpu()).numpy()
    for d, k in zip(og_sha.digest_to_bytes(digests), ok_rows.cpu().numpy()):
        red = sha_fold_mod_l(int.from_bytes(d.tobytes(), "little"))
        check(red[0] == int.from_bytes(k.tobytes(), "little"),
              "sha_fold_mod_l disagrees with sha512_challenge")
    red_slots = red[2] + red[1] * INT32_LANES_PER_SM / WIDE_PER_SM_CLOCK
    ops["sha512_challenge"] = (SHA_OPS_PER_BLOCK * blocks_used + red_slots * n_og) / n_og
    kernel_ops = {"sha512_challenge": (SHA_KERNEL_OPS_PER_BLOCK * blocks_used
                                       + SHA_KERNEL_OPS_REDUCE * n_og) / n_og,
                  "og_verify": og_kernel["slots"], "og_verify_cached": og_kernel["slots"]}
    log(f"timing: sha512_challenge hashes {blocks_used} SHA-512 blocks for {n_og} messages "
        f"({SHA_OPS_PER_BLOCK} operations a block, a reduction {red[1]} 32 x 32 -> 64 products "
        f"and {red[2]} operations, {red_slots:.1f} slots; the source's count "
        f"{SHA_KERNEL_OPS_PER_BLOCK} a block and {SHA_KERNEL_OPS_REDUCE} a reduction)")
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
            "kernel_ops_per_unit": kernel_ops.get(name),
            "products_per_unit": products.get(
                name, SECP_WIDE_PER_SIG if name.startswith("secp_") else None),
            "units": units,
            "bytes": io_bytes,
        })
        log(f"timing: {name} {ms:.3f} ms over {units} units; bound "
            f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of it reached "
            f"({ops[name] * units / 1e9:.3f} G "
            f"multiply-add slots -> {ops_ms:.4f} ms, {io_bytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms)")
    return records


# -- slice (h): the BLS12-381 aggregated-commit lane ----------------------------


def bls_bad_g1(count: int) -> list:
    """The first `count` on-curve G1 points outside the prime-order
    subgroup, by smallest x (tools/prep_bench.py's crafting), compressed."""
    out, x = [], 1
    while len(out) < count:
        y = bls12381.fp_sqrt((x * x * x + bls12381.B) % bls12381.P)
        if y is not None and not bls12381.g1_in_subgroup((x, y)):
            out.append(bls12381.g1_compress((x, y)))
        x += 1
    return out


def bls_bad_g2() -> bytes:
    """The first on-curve G2 point (c, 0) outside the subgroup, compressed."""
    c = 1
    while True:
        x = (c, 0)
        y = bls12381.f2_sqrt(bls12381.f2_add(bls12381.f2_mul(x, bls12381.f2_sqr(x)),
                                             bls12381.f2_scalar(bls12381.XI, bls12381.B)))
        if y is not None and not bls12381.g2_in_subgroup((x, y)):
            return bls12381.g2_compress((x, y))
        c += 1


def bls_keys(n: int) -> list:
    """The compressed keys of sk = 1..n, by successive addition of g1
    (pk_(i+1) = pk_i + g1), not n scalar multiplications."""
    out, pt = [], None
    for _ in range(n):
        pt = bls12381.g1_add(pt, bls12381.G1_GEN)
        out.append(bls12381.g1_compress(pt))
    return out


def bls_battery_committee(n: int) -> list:
    """(h1)'s committee of n keys: sk = 1..n-3 at rows 0..n-4, two
    crafted non-subgroup keys at rows n-3 and n-2, and at row n-1 the key
    of sk = r - 10, which cancels rows 0..3 (sk 1 + 2 + 3 + 4 = 10)."""
    cancel = bls12381.g1_neg(bls12381.g1_mul(10, bls12381.G1_GEN))
    return bls_keys(n - 3) + bls_bad_g1(2) + [bls12381.g1_compress(cancel)]


def bls_battery(n: int, msg: bytes) -> tuple:
    """(h1)'s commits over bls_battery_committee(n), all signing `msg`, and
    their expected verdict codes: valid (every honest key, then rows 0
    and 2), a wrong signature, a malformed, an identity and a
    non-subgroup signature, signers taking both crafted keys (the lower
    row blamed) and an identity aggregate (rows 0..3 and n-1) under a
    valid signature."""
    h = bls12381.hash_to_g2(msg)

    def sig(s: int) -> bytes:
        return bls12381.g2_compress(bls12381.g2_mul(s, h))

    def bits(rows) -> np.ndarray:
        b = np.zeros(n, dtype=bool)
        b[list(rows)] = True
        return b

    honest = range(n - 3)
    items = [
        (bits(honest), msg, sig(sum(i + 1 for i in honest))),
        (bits([0, 2]), msg, sig(4)),
        (bits([0, 1]), msg, sig(5)),  # signs 3
        (bits([0, 1]), msg, b"\xff" * 96),
        (bits([0, 1]), msg, bytes([0xC0]) + bytes(95)),
        (bits([0, 1]), msg, bls_bad_g2()),
        (bits([1, n - 2, n - 3]), msg, sig(2)),
        (bits([0, 1, 2, 3, n - 1]), msg, sig(2)),
    ]
    codes = [bls_verify.CODE_VALID, bls_verify.CODE_VALID, bls_verify.CODE_PAIRING,
             bls_verify.CODE_SIG["malformed"], bls_verify.CODE_SIG["identity"],
             bls_verify.CODE_SIG["subgroup"], bls_verify.CODE_PUB_BASE + n - 3,
             bls_verify.CODE_APK_IDENTITY]
    return items, codes


def bls_finalexp_rows(n_random: int, seed: int) -> np.ndarray:
    """Rows for bls_finalexp's edge cases, (2 + n_random, 6, 2, 12) int32
    words: f = 0 (its inversion maps 0 to 0, so the residue is 0), f = 1,
    then seeded random nonzero elements."""
    rng = random.Random(seed)
    vals = [0] * 12 + [1] + [0] * 11
    vals += [rng.randrange(1, bls12381.P) for _ in range(12 * n_random)]
    return fe_bls.words_from_ints(vals).reshape(2 + n_random, 6, 2, 12)


def bls_fp_products(name: str, k: int, vp: int) -> int:
    """The Fp products (BLS_WIDE_PER_FP multiply-adds each) of one launch,
    as csrc/bls12381.cu's header counts them: bls_miller over k commits
    and vp table rows; bls_finalexp fused over k rows (k = rows for
    launch B, each its own exponentiation)."""
    if name == "bls_miller":
        return k * (14 * vp + 127 * 12 + 6 + BLS_STEP_PRODUCTS * bls_verify.N_ATE + 15)
    if name == "bls_finalexp_fused":
        return BLS_FINALEXP_PRODUCTS + (BLS_F12_PRODUCT + 12) * (k - 1)
    return k * BLS_FINALEXP_PRODUCTS


def bls_bound_products(name: str, masks: np.ndarray, coeffs: np.ndarray) -> int:
    """The Fp products the function of one launch needs on these inputs
    (the BLS bound's counts above): bls_miller over masks (k, vp) and
    coeffs (k, 2, N_ATE, 2, 2, 2, 12), from each commit's signers and
    nonzero lines; bls_finalexp fused over the k rows
    (bls_finalexp_fused), or each row alone."""
    k = masks.shape[0]
    if name == "bls_finalexp_fused":
        return BLS_F12_MUL * (k - 1) + BLS_FINALEXP_BOUND
    if name == "bls_finalexp":
        return k * BLS_FINALEXP_BOUND
    signers = masks.reshape(k, -1).sum(axis=1)
    lines = coeffs.reshape(k, 2, -1, 2, 4 * bls_verify.NW).any(axis=-1).sum(axis=(2, 3))
    total = 0
    for j in range(k):
        total += (BLS_MIXED_ADD * max(int(signers[j]) - 1, 0)
                  + BLS_F12_SQ * (bls_verify.N_ATE - 1)
                  + sum(e * int(n) for e, n in zip(BLS_LINE_EVAL, lines[j]))
                  + BLS_LINE_MUL * (int(lines[j].sum()) - 2))
    return total


def bls_codes(apk, res, fused, ok, reasons) -> tuple:
    """The verdict codes run_verify and verdict_codes give from launch A's
    apk and fused residue and launch B's residues (read back), and
    whether the fused residue was 1."""
    apk_nz = apk[:, 2].any(axis=1)
    lane_ok = np.asarray(ok) & apk_nz
    pair_ok = np.array([bls_verify.residue_is_one(r) for r in res])
    codes = bls_verify.verdict_codes(lane_ok & pair_ok, lane_ok & ~pair_ok, apk_nz, reasons)
    return codes, bls_verify.residue_is_one(fused)


def bls_kernel_phase(stats: dict, dev) -> dict:
    """(h1): both BLS kernels against their plain versions on the card, at
    each (K, committee) of BLS_SHAPES, over the battery (and pad commits
    past it): apk, f_j, the fused residue and launch B's residues word
    for word, and the codes they give equal to the battery's."""
    msg = b"chip smoke (h1) aggregate"
    out = {}
    for k, n in BLS_SHAPES:
        pubs = bls_battery_committee(n)
        items, want = bls_battery(n, msg)
        pub48 = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(n, 48)
        tables = [torch.from_numpy(a).to(dev) for a in bls_verify.table_columns_g1(pubs)]
        bad = bls_verify.bad_rows(pub48)
        check(bad == [n - 3, n - 2], f"(h1) the crafted keys' rows {bad}")
        got = []
        for c in range(0, len(items), k):
            chunk = items[c : c + k]
            masks, coeffs, ok, reasons = bls_verify.prepare_commits(chunk, k, n + 1, bad)
            t = tables + [torch.from_numpy(masks).to(dev), torch.from_numpy(coeffs).to(dev)]
            label = f"K = {k}, {n} keys, commits {c}..{c + len(chunk) - 1}"
            apk, f = hold(stats, "bls_miller", label, lambda: bls_verify.verify_plain(*t),
                          lambda: bls_verify.bls_miller(*t))
            res = hold(stats, "bls_finalexp", label + " rows",
                       lambda: bls_verify.finalexp_plain(f), lambda: bls_verify.bls_finalexp(f))
            fused = hold(stats, "bls_finalexp", label + " fused",
                         lambda: bls_verify.finalexp_plain(f, fused=True),
                         lambda: bls_verify.bls_finalexp(f, fused=True))
            codes, one = bls_codes(apk.cpu().numpy(), res.cpu().numpy(), fused[0].cpu().numpy(),
                                   ok, reasons)
            check(one == bool((codes == bls_verify.CODE_VALID).all()),
                  f"(h1) the fused residue is {'1' if one else 'not 1'} at {label}")
            got.extend(codes[: len(chunk)].tolist())
            check((codes[len(chunk):] == bls_verify.CODE_VALID).all(),
                  f"(h1) a pad commit failed at {label}")
        check(got == want, f"(h1) codes {got} at K = {k}, {n} keys, wanted {want}")
        out[f"K{k}_n{n}"] = got
        log(f"slice (h1): K = {k} over {n} keys: both kernels equal their plain versions "
            f"word for word; codes {got} as expected")
    rows = torch.from_numpy(bls_finalexp_rows(BLS_EDGE_RANDOM, seed=18)).to(dev)
    label = f"f = 0, f = 1 and {BLS_EDGE_RANDOM} random rows"
    res = hold(stats, "bls_finalexp", label, lambda: bls_verify.finalexp_plain(rows),
               lambda: bls_verify.bls_finalexp(rows))
    hold(stats, "bls_finalexp", label + " fused (f = 1 and the random rows)",
         lambda: bls_verify.finalexp_plain(rows[1:], fused=True),
         lambda: bls_verify.bls_finalexp(rows[1:], fused=True))
    res = res.cpu().numpy()
    check(not res[0].any() and bls_verify.residue_is_one(res[1])
          and res[2:].any(axis=(1, 2, 3)).all(),
          "(h1) the final exponentiation of 0 is not 0, or of 1 not 1")
    out["edge_rows"] = len(rows)
    log(f"slice (h1): bls_finalexp on {label}, by rows and fused, equals its plain version "
        "word for word; 0 gives 0 and 1 gives 1")
    return out


def _bls_agg(height: int, n: int, signature: bytes = b"") -> "AggregatedCommit":
    """(h2)'s aggregated commit at `height` over n validators, every one
    signing."""
    full = BitArray(n)
    for i in range(n):
        full.set_index(i, True)
    return AggregatedCommit(height=height, round=0, block_id=BLS_BLOCK, signature=signature,
                            signers=full)


def _bls_sign(job: tuple) -> bytes:
    """job (height, n): the aggregate of n validators' signatures at
    `height`, (sum sk) H(m), sk_i = i + 1."""
    height, n = job
    msg = _bls_agg(height, n).sign_bytes(BLS_CHAIN)
    return bls12381.g2_compress(bls12381.g2_mul(n * (n + 1) // 2, bls12381.hash_to_g2(msg)))


def build_bls_data(pool) -> dict:
    """(h2)'s committee (bench.py bls: BLS_VALIDATORS validators of power
    BLS_POWER, sk_i = i + 1), the key statuses (in this process: they
    are memoized here), and the windows' commits, signed by the pool (a
    warm-up, BLS_WINDOWS timed, one tampered)."""
    t = time.perf_counter()
    keys = bls_keys(BLS_VALIDATORS)
    derive_s = time.perf_counter() - t
    t = time.perf_counter()
    check(all(bls12381.pubkey_status(k)[1] is None for k in keys), "a committee key is bad")
    status_s = time.perf_counter() - t
    vset = ValidatorSet.new([Validator.new(bls12381.PubKey(k), BLS_POWER) for k in keys])
    t = time.perf_counter()
    heights = range(1, 1 + (BLS_WINDOWS + 2) * BLS_WINDOW)
    sigs = pool.map(_bls_sign, [(h, BLS_VALIDATORS) for h in heights])
    aggs = [_bls_agg(h, BLS_VALIDATORS, s) for h, s in zip(heights, sigs)]
    windows = [aggs[w * BLS_WINDOW : (w + 1) * BLS_WINDOW] for w in range(BLS_WINDOWS + 2)]
    # the tampered commit carries another height's (valid) aggregate
    windows[-1][BLS_TAMPER].signature = windows[0][0].signature
    sign_s = time.perf_counter() - t
    log(f"data: {BLS_VALIDATORS} bls12381 keys derived in {derive_s:.2f} s, their statuses in "
        f"{status_s:.1f} s; {len(windows) * BLS_WINDOW} aggregated commits signed in "
        f"{sign_s:.1f} s")
    return {"vset": vset, "windows": windows, "derive_s": derive_s, "status_s": status_s,
            "sign_s": sign_s}


@contextlib.contextmanager
def bls_spies():
    """Record each BLS kernel launch's rows and CUDA events, and the
    dispatcher's host prep of each BLS batch, inside the block."""
    rec = {"prep": [], "miller": [], "finalexp": []}
    real_prep = bls_verify.prepare_batch
    real_miller, real_fe = bls_verify.bls_miller, bls_verify.bls_finalexp

    def prep(block, ep=None):
        t = time.perf_counter()
        out = real_prep(block, ep)
        rec["prep"].append((len(block), (time.perf_counter() - t) * 1e3))
        return out

    def timed(kind, real, rows):
        def call(*args, **kw):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kw)
            stop.record()
            rec[kind].append((rows(*args, **kw), start, stop))
            return out
        return call

    bls_verify.prepare_batch = prep
    bls_verify.bls_miller = timed("miller", real_miller, lambda gx, gy, m, c: m.shape[0])
    bls_verify.bls_finalexp = timed("finalexp", real_fe,
                                    lambda f, fused=False: 1 if fused else f.shape[0])
    try:
        yield rec
    finally:
        bls_verify.prepare_batch = real_prep
        bls_verify.bls_miller, bls_verify.bls_finalexp = real_miller, real_fe


def bls_run_window(vset, window: list, dev) -> tuple:
    """A window through prepare_aggregated_commit (k_hint the window),
    the shared dispatcher and conclude: (per commit None or its blame,
    end-to-end ms)."""
    t = time.perf_counter()
    pairs = [validation.prepare_aggregated_commit(BLS_CHAIN, vset, BLS_BLOCK, agg.height, agg,
                                                  k_hint=len(window)) for agg in window]
    v = pipeline.shared_verifier(dev)
    futs = [v.submit(blk) for blk, _ in pairs]
    out = []
    for (_, conclude), fut in zip(pairs, futs):
        try:
            conclude(fut.result(timeout=600))
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out, (time.perf_counter() - t) * 1e3


def bls_host_steps(vset) -> dict:
    """The host prep of one aggregated commit (at a height no window
    uses, so nothing is memoized), step by step, ms: H(m), the
    signature's status (decompression, subgroup check), the weighted G2
    points z H and z sigma, their line coefficients."""
    agg = _bls_agg(10**6, vset.size())
    msg = agg.sign_bytes(BLS_CHAIN)
    out = {}

    def step(name, fn):
        t = time.perf_counter()
        r = fn()
        out[name] = (time.perf_counter() - t) * 1e3
        return r

    h = step("hash_to_g2", lambda: bls12381.hash_to_g2(msg))
    sig = bls12381.g2_compress(bls12381.g2_mul(vset.size() * (vset.size() + 1) // 2, h))
    s, _ = step("signature_status", lambda: bls12381.signature_status(sig))
    z = bls_verify.rlc_weights([(np.ones(vset.size(), bool), msg, sig)])[0]
    zh = step("g2_mul_z_h", lambda: bls12381.g2_mul(z, h))
    zs = step("g2_mul_z_sigma", lambda: bls12381.g2_mul(z, s))
    step("line_coefficients_x2", lambda: (bls_verify._coeff_rows(zh), bls_verify._coeff_rows(zs)))
    return out


def bls_phase(data: dict, dev) -> tuple:
    """(h2) and (h3) on the card. Returns the numbers and the launches of
    (h2)'s windows."""
    vset, windows = data["vset"], data["windows"]
    epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    runs, launches = [], {}
    steps = bls_host_steps(vset)
    log("slice (h2): one commit's host prep, ms: " + ", ".join(
        f"{k} {v:.1f}" for k, v in steps.items()))
    for w, window in enumerate(windows):
        tampered = w == len(windows) - 1
        with launch_threads() as launchers, bls_spies() as rec:
            kernels.reset_launches()
            got, e2e = bls_run_window(vset, window, dev)
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check_dispatcher_launched(launchers, dev, f"slice (h2) window {w}")
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        want = [None] * len(window)
        if tampered:
            sig = window[BLS_TAMPER].signature
            want[BLS_TAMPER] = f"wrong aggregate signature: {sig.hex().upper()}"
        check(got == want, f"(h2) window {w}: verdicts {[g and g[:40] for g in got]}")
        widths = [r for r, _, _ in rec["miller"]]
        fe_rows = [r for r, _, _ in rec["finalexp"]]
        check(widths == [BLS_WINDOW] and [n for n, _ in rec["prep"]] == [BLS_WINDOW],
              f"(h2) window {w}: launch A widths {widths}, batches {rec['prep']}")
        check(fe_rows == ([1, BLS_WINDOW] if tampered else [1]),
              f"(h2) window {w}: final exponentiation rows {fe_rows}")
        check(launched == {"bls_miller": 1, "bls_finalexp": 2 if tampered else 1},
              f"(h2) window {w} launched {launched}")
        runs.append({
            "e2e_ms": e2e,
            "host_prep_ms": rec["prep"][0][1],
            "launch_a_miller_ms": rec["miller"][0][1].elapsed_time(rec["miller"][0][2]),
            "launch_a_finalexp_ms": rec["finalexp"][0][1].elapsed_time(rec["finalexp"][0][2]),
            "launch_b_ms": (rec["finalexp"][1][1].elapsed_time(rec["finalexp"][1][2])
                            if tampered else None),
        })
        log(f"slice (h2) window {w}{' (tampered)' if tampered else ''}: {BLS_WINDOW} commits, "
            f"launched {launched}; " + ", ".join(
                f"{k} {v:.1f}" for k, v in runs[-1].items() if v is not None))
    timed = runs[1:-1]
    med = {k: statistics.median(r[k] for r in timed) for k in timed[0] if k != "launch_b_ms"}
    med["commits_per_s"] = BLS_WINDOW / med["e2e_ms"] * 1e3
    out = {"windows": runs, "median": med, "launches": launches, "host_steps_ms": steps}
    log(f"slice (h2): median of {len(timed)} windows of {BLS_WINDOW} commits over "
        f"{BLS_VALIDATORS} validators: " + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
        + f"; tampered window: launch B {runs[-1]['launch_b_ms']:.1f} ms, the blame exact")

    # (h3) the sequential walk and the synchronous backend path
    window = windows[-1]
    for i in (0, BLS_TAMPER):
        agg = window[i]

        def walk():
            validation.verify_aggregated_commit(BLS_CHAIN, vset, BLS_BLOCK, agg.height, agg)

        t = time.perf_counter()
        if i == BLS_TAMPER:
            expect_error(walk, ValueError,
                         f"wrong aggregate signature: {agg.signature.hex().upper()}")
        else:
            walk()
        out.setdefault("walk_ms", []).append((time.perf_counter() - t) * 1e3)
    pub48 = vset.bls12381_columns()[0]
    full = np.ones(vset.size(), dtype=bool)
    block = AggBlock.from_commits([(full, a.sign_bytes(BLS_CHAIN), a.signature) for a in window],
                                  pub48, vset.hash())
    before = dict(kernels.LAUNCHES)
    codes = backend.verify_batch_bls_codes(block, device=dev)
    want = [bls_verify.CODE_VALID] * len(window)
    want[BLS_TAMPER] = bls_verify.CODE_PAIRING
    check(codes.tolist() == want, f"(h3) verify_batch_bls_codes gave {codes.tolist()}")
    check(_launched(before) == {"bls_miller": 1, "bls_finalexp": 2},
          f"(h3) verify_batch_bls_codes launched {_launched(before)}")
    log(f"slice (h3): verify_aggregated_commit on commits 0 and {BLS_TAMPER} "
        f"({', '.join(f'{x:.0f}' for x in out['walk_ms'])} ms) and verify_batch_bls_codes on "
        "the tampered window agree with (h2)'s verdicts and blame")
    return out, launches


def bls_timing(data: dict, stats: dict, dev, sm_clock_hz: float) -> list:
    """Both BLS kernels at (h2)'s shape (K = BLS_WINDOW, the epoch table's
    vp rows), on the tampered window (so launch B meets a residue that is
    not 1): each held word for word to its plain version (bls_miller, launch
    B's rows, the fused bls_finalexp, whose plain time the record keeps),
    then timed with CUDA events beside its bound: bls_miller, the fused
    bls_finalexp and launch B's rows, KERNEL_REPS launches each. Returns
    their kernel records."""
    vset, window = data["vset"], data["windows"][-1]
    epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    epoch_cache.note_valset(vset)
    ep = epoch_cache.cache().get(vset.hash())
    pub48 = vset.bls12381_columns()[0]
    full = np.ones(vset.size(), dtype=bool)
    block = AggBlock.from_commits([(full, a.sign_bytes(BLS_CHAIN), a.signature) for a in window],
                                  pub48, vset.hash())
    batch = bls_verify.prepare_batch(block, ep)
    gx, gy = ep.bls_tables(dev)
    masks, coeffs = (torch.from_numpy(a).to(dev) for a in batch.args)
    k, vp = masks.shape
    label = f"(h2)'s tampered window, K = {k}, vp = {vp}"
    apk, f = hold(stats, "bls_miller", label, lambda: bls_verify.verify_plain(gx, gy, masks, coeffs),
                  lambda: bls_verify.bls_miller(gx, gy, masks, coeffs))
    res = hold(stats, "bls_finalexp", label + " rows", lambda: bls_verify.finalexp_plain(f),
               lambda: bls_verify.bls_finalexp(f))
    rows_plain_ms = stats["bls_finalexp"]["plain_ms"]
    fused = hold(stats, "bls_finalexp", label + " fused",
                 lambda: bls_verify.finalexp_plain(f, fused=True),
                 lambda: bls_verify.bls_finalexp(f, fused=True))
    one = [bls_verify.residue_is_one(r) for r in res.cpu().numpy()]
    check(one == [j != BLS_TAMPER for j in range(k)] and not bls_verify.residue_is_one(
        fused[0].cpu().numpy()), f"(h2) residues at {label}: {one}")
    rate = SMS * WIDE_PER_SM_CLOCK * sm_clock_hz
    host = (batch.args[0], batch.args[1])
    runs = {
        "bls_miller": (lambda: bls_verify.bls_miller(gx, gy, masks, coeffs),
                       (gx, gy, masks, coeffs, apk, f), "bls_miller", KERNEL_REPS),
        "bls_finalexp": (lambda: bls_verify.bls_finalexp(f, fused=True), (f, fused),
                         "bls_finalexp_fused", KERNEL_REPS),
    }
    records = []
    for name, (fn, tensors, kind, reps) in runs.items():
        products = bls_bound_products(kind, *host)
        ms = event_ms(fn, reps)
        io_bytes = sum(t.nbytes for t in tensors)
        ops_ms = products * BLS_WIDE_PER_FP / rate * 1e3
        bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        source, replaces = KERNELS[name]
        records.append({
            "name": name, "route": "cuda", "source": f"tendermint_tpu_torch/csrc/{source}",
            "replaces": replaces, "ms": ms, "bound_ms": bound_ms,
            "pct_of_bound": 100 * bound_ms / ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
            "bound_fp_products": products, "kernel_fp_products": bls_fp_products(kind, k, vp),
            "units": k, "bytes": io_bytes,
        })
        log(f"timing: {name} {ms:.3f} ms at K = {k}, vp = {vp}; bound {bound_ms:.6f} ms "
            f"({products} Fp products the function needs, the kernel forms "
            f"{records[-1]['kernel_fp_products']}; {products * BLS_WIDE_PER_FP / 1e9:.4f} G "
            f"multiply-adds -> {ops_ms:.6f} ms; {io_bytes / 1e6:.3f} MB -> {bytes_ms:.6f} ms)")
    rows_ms = event_ms(lambda: bls_verify.bls_finalexp(f), KERNEL_REPS)
    rows_bound = bls_bound_products("bls_finalexp", *host) * BLS_WIDE_PER_FP / rate * 1e3
    records[-1].update(launch_b_ms=rows_ms, launch_b_bound_ms=rows_bound,
                       launch_b_plain_ms=rows_plain_ms)
    log(f"timing: bls_finalexp launch B over {k} rows {rows_ms:.3f} ms (bound "
        f"{rows_bound:.6f} ms, plain {rows_plain_ms:.1f} ms)")
    return records


# -- slice (j): multi-device commit verification --------------------------------

# (j1): (rows, m) of the tally's holds; the last is the one-shard commit's
# shape, whose plain time is kept
TALLY_CASES = ((1, 1), (2_560 * 4, 4), (10_240, 1))
SHARD_FACES = ("sharded", "sharded_cached", "pallas", "rlc")
# each face's kernels a shard launches before its commit_tally
SHARD_KERNELS = {
    "sharded": ("og_verify",),
    "sharded_cached": ("og_verify_cached",),
    "pallas": ("k1_decompress", "k2_table", "k3_ladder"),
    "rlc": ("k1_rlc", "k2_rlc", "k3_rlc"),
}
MESH_JOBS = 24  # bench.py multichip's defaults (bench.py:647-651): 24 jobs
MESH_JOB_SIGS = 1_024  # of 1,024 signatures, the lane capacity
MESH_LANES = (1, 2, 4)
MESH_SETS = (1, 10, 17)  # the commits of V1 (cold), V2 and V3 (warm): slice (e)'s
MESH_TAMPER = (5, 100)  # (job, row) of the tampered signature
MESH_RUNS = 3  # timed runs a point (median)
# the point at the default lane capacity (BUCKETS[-1]): whole commits as
# jobs, V1's (cold), V2's and V3's (warm) and V1's again with TAMPER_AT
# tampered, one a lane: a superbatch of 4 x 10,240 = 40,960 rows
MESH_CAP_LANES = 4
# the mixed committee, of N_VALIDATORS: the first of slice (a)'s ed25519
# set and of slice (g)'s secp256k1 set (sorted order), with their signatures
SPLIT_VALIDATORS = (5_000, 5_000)
SPLIT_TAMPER = 3  # its tampered signatures: the first secp256k1 row from here, and the
# first ed25519 row after it (both inside the early stop; the blame is the first)


def tally_inputs(rows: int, m: int, seed: int, all_invalid: bool = False) -> tuple:
    """(valid, live, power lanes): verdicts of 0 and 1, the last eighth of
    the rows padding (not live), powers up to the top of the range."""
    rng = np.random.default_rng(seed)
    valid = rng.integers(0, 2, rows // m).astype(np.int32)
    if all_invalid:
        valid[:] = 0
    live = np.ones(rows, np.int32)
    live[rows - rows // 8 :] = 0
    powers = rng.integers(1, 1 << 60, rows)
    powers[0] = (1 << 60) - 1
    return valid, live, sharded.split_power(powers)


def host_tally(valid, live, pw, m: int) -> list:
    ok = np.repeat(valid != 0, m) & (live != 0)
    return pw[ok].sum(axis=0, dtype=np.int64).tolist() + [int(((live != 0) & ~np.repeat(
        valid != 0, m)).sum())]


def tally_kernel_phase(stats: dict, dev) -> tuple:
    """(j1) commit_tally against its plain version on the card, word for
    word, and against numpy: one row, 2,560 lanes of 4 (m = 4), 10,240
    rows; each also as an all-invalid shard. Returns the last shape's
    inputs on the card, which the timing reuses."""
    for rows, m in TALLY_CASES:
        for all_invalid in (True, False):
            host = tally_inputs(rows, m, rows + m, all_invalid)
            ins = [torch.from_numpy(x).to(dev) for x in host]
            label = f"{rows} rows, m = {m}" + (", all invalid" if all_invalid else "")
            got = hold(stats, "commit_tally", label,
                       lambda: sharded.commit_tally_plain(*ins, m),
                       lambda: sharded.commit_tally(*ins, m))
            check(got.cpu().tolist() == host_tally(*host, m),
                  f"commit_tally at {label} differs from numpy's tally")
    log("kernels: commit_tally equals its plain version and numpy's tally on every case")
    return ins


def _shard_call(face: str, block: EntryBlock, powers: list, mesh) -> tuple:
    if face == "pallas":
        return sharded.verify_commit_sharded_pallas(block, powers, mesh)
    if face == "rlc":
        return sharded.verify_commit_sharded_rlc(block, powers, mesh)
    return sharded.verify_commit_sharded(block, powers, mesh)


@contextlib.contextmanager
def launch_order():
    """The names of the kernels launched inside the block, in order."""
    order = []
    real = kernels.launch

    def spy(name, *args):
        real(name, *args)
        order.append(name)

    kernels.launch = spy
    try:
        yield order
    finally:
        kernels.launch = real


def sharded_phase(vals, ents: list, dev) -> tuple:
    """(j2) The 10,000-validator commit through verify_commit_sharded
    (cold), its warm form (the epoch cache holding the set: the cached
    kernel over each device's table), _pallas and _rlc, each on
    make_mesh(1) and on Mesh((cuda:0, cuda:0)) (two shards of 5,120):
    verdicts, tally and all_valid equal to the single-device verdicts of
    backend.verify_batch and the host tally; each shard launches its
    verify kernels then one commit_tally. A tampered signature is blamed
    at its row and its power left out. Then the median of REPEATS calls
    of each. Returns (the stats, the launches of the valid calls)."""
    powers = [v.voting_power for v in vals.validators]
    cold = EntryBlock.from_entries(ents)
    epoch_cache.reset(depth=epoch_cache.DEFAULT_DEPTH)
    check(epoch_cache.note_valset(vals) is None and epoch_cache.note_valset(vals) is not None,
          "the set is not warm after two sightings")
    rows = np.arange(len(ents), dtype=np.int32)
    warm = EntryBlock(cold.pub, cold.sig, cold.msgs, cold.offsets, val_idx=rows,
                      epoch_key=vals.hash())
    bad_ents = list(ents)
    p, m, s = bad_ents[TAMPER_AT]
    bad_ents[TAMPER_AT] = (p, m, tamper(s))
    bad_cold = EntryBlock.from_entries(bad_ents)
    bad_warm = EntryBlock(bad_cold.pub, bad_cold.sig, bad_cold.msgs, bad_cold.offsets,
                          val_idx=rows, epoch_key=vals.hash())
    want = backend.verify_batch(cold, device=dev)
    want_bad = backend.verify_batch(bad_cold, device=dev)
    check(bool(want.all()) and np.nonzero(~want_bad)[0].tolist() == [TAMPER_AT],
          "the single-device verdicts are not the commit's")
    total = sum(powers)
    meshes = {"1 card": sharded.make_mesh(1), "2 shards on 1 card": sharded.Mesh([dev, dev])}
    blocks = {"sharded": (cold, bad_cold), "sharded_cached": (warm, bad_warm),
              "pallas": (cold, bad_cold), "rlc": (cold, bad_cold)}
    out = {"faces": {}}
    kernels.reset_launches()
    for face in SHARD_FACES:
        good, bad = blocks[face]
        for label, mesh in meshes.items():
            nd = len(mesh)
            with launch_order() as order:
                valid, tallied, all_valid = _shard_call(face, good, powers, mesh)
            order = [k for k in order if k != "epoch_coords"]  # the table, once a device
            per_shard = list(SHARD_KERNELS[face]) + ["commit_tally"]
            check(order == per_shard * nd, f"{face} on {label} launched {order}, wanted "
                  f"{per_shard} a shard")
            check(valid.tolist() == want.tolist() and tallied == total and all_valid is True,
                  f"{face} on {label}: verdicts, tally or all_valid differ from the "
                  f"single-device path ({tallied} of {total})")
            valid, tallied, all_valid = _shard_call(face, bad, powers, mesh)
            check(valid.tolist() == want_bad.tolist() and all_valid is False
                  and tallied == total - powers[TAMPER_AT],
                  f"{face} on {label}: the tampered commit's verdicts or tally are wrong")
            log(f"sharded ({face}, {label}): verdicts and tally equal the single-device path; "
                f"#{TAMPER_AT} blamed, its power {powers[TAMPER_AT]} left out; launches "
                f"{per_shard} x {nd}")
    launches = dict(kernels.LAUNCHES)
    for face in SHARD_FACES:
        good, _ = blocks[face]
        for label, mesh in meshes.items():
            ms = []
            for _ in range(REPEATS):
                _, t = _timed(lambda: _shard_call(face, good, powers, mesh))
                ms.append(t)
            out["faces"][f"{face} / {label}"] = {
                "median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms)}
    log("sharded timing (median ms of " + str(REPEATS) + "): " + ", ".join(
        f"{k} {v['median_ms']:.2f}" for k, v in out["faces"].items()))
    return out, {k: v for k, v in launches.items() if v}


def _job_blocks(light_wire: dict, ents: list, vals) -> tuple:
    """(blocks, the commits' (set, entries)): MESH_JOBS blocks of MESH_JOB_SIGS
    signatures, job i from set i % 3 (V1's commit, then V2's and V3's of
    the light chain), with their validator rows; V2 and V3 warm (noted
    twice), V1 cold. The signature MESH_TAMPER is tampered."""
    sets = [(vals, ents)]
    for h in MESH_SETS[1:]:
        hv, hc = convert.state_from_wire(light_wire[h][2], light_wire[h][1])
        sets.append((hv, commit_entries(hc, hv)))
    for hv, _ in sets[1:]:
        epoch_cache.note_valset(hv)
        check(epoch_cache.note_valset(hv) is not None, "a mesh set is not warm")
    blocks = []
    for i in range(MESH_JOBS):
        sv, se = sets[i % 3]
        lo = (i // 3) * MESH_JOB_SIGS
        part = list(se[lo : lo + MESH_JOB_SIGS])
        if i == MESH_TAMPER[0]:
            p, m, s = part[MESH_TAMPER[1]]
            part[MESH_TAMPER[1]] = (p, m, tamper(s))
        b = EntryBlock.from_entries(part)
        if i % 3:
            b.val_idx = np.arange(lo, lo + MESH_JOB_SIGS, dtype=np.int32)
            b.epoch_key = sv.hash()
        blocks.append(b)
    return blocks, sets


def submit_together(v, blocks: list, seen: list = None) -> list:
    """Submit `blocks` so one drain of the coalescer takes them: a
    one-signature primer's host stage holds the coalescer until all are
    queued. Returns their futures; `seen` collects the (block, plan) of
    every superbatch after the primer's (the stage stays wrapped: close
    the verifier after)."""
    entered, gate = threading.Event(), threading.Event()
    inner = v._prepare

    def held(block, plan):
        if not gate.is_set():
            entered.set()
            check(gate.wait(60), "the primer's gate was never opened")
        elif seen is not None:
            seen.append((block, plan))
        return inner(block, plan)

    v._prepare = held
    primer = v.submit(EntryBlock.from_entries([edge_entries()[0]]))
    check(entered.wait(60), "the primer never reached its host stage")
    futs = [v.submit(b) for b in blocks]
    gate.set()
    check(bool(primer.result(timeout=600).all()), "the primer did not verify")
    return futs


def build_split_committee(vals, commit, secp_vals, secp_commit) -> tuple:
    """(ValidatorSet, Commit) of SPLIT_VALIDATORS ed25519 and secp256k1
    validators: the first of slice (a)'s set and of slice (g)'s, with the
    signatures they gave (one vote, timestamps by key), powers 1..999
    from the seed."""
    picked = []
    for (vs, c), n in zip(((vals, commit), (secp_vals, secp_commit)), SPLIT_VALIDATORS):
        picked += [(v.pub_key, cs) for v, cs in zip(vs.validators[:n], c.signatures[:n])]
    powers = np.random.default_rng(SEED + 7).integers(1, 1000, len(picked))
    svals = ValidatorSet.new([Validator.new(pk, int(pw)) for (pk, _), pw in zip(picked, powers)])
    by_pub = {pk.bytes(): cs for pk, cs in picked}
    return svals, Commit(HEIGHT, ROUND, BLOCK, [by_pub[v.pub_key.bytes()]
                                                for v in svals.validators])


def _mesh_run(v, blocks: list) -> tuple:
    t = time.perf_counter()
    futs = [v.submit(b) for b in blocks]
    res = [f.result(timeout=600) for f in futs]
    return res, (time.perf_counter() - t) * 1e3


def _mesh_point(key: str, dev, lanes: int, lane_bucket, mesh, blocks: list, want: list) -> tuple:
    """One (j3) point: a mesh-mode dispatcher of `lanes` lanes (lane
    capacity lane_bucket, None the default) on `mesh` (None: the default
    mesh, one card) runs `blocks` once to warm, once checked (each job's
    verdicts equal `want`, the single-lane dispatcher's), MESH_RUNS timed
    runs and one traced run. Returns (the point's stats, each superbatch
    of the checked run as (n_lanes, live lanes, placed, warm, rows))."""
    plans = []
    holder = {}

    def make():
        v = holder["v"] = pipeline.AsyncBatchVerifier(
            dev, mesh_lanes=lanes, lane_bucket=lane_bucket, mesh=mesh)
        inner = v._prepare

        def spy(block, plan):
            b = inner(block, plan)
            plans.append((plan.n_lanes, len(plan.lanes), b.placement is not None,
                          plan.epoch_key() is not None, plan.bucket))
            return b

        v._prepare = spy
        _mesh_run(v, blocks)

    make()
    v = holder["v"]
    ready = sharded.mesh_ready(lanes, v.mesh)
    plans.clear()
    res, _ = _mesh_run(v, blocks)
    first = list(plans)
    check(all(np.array_equal(r, w) for r, w in zip(res, want)),
          f"mesh ({key}) verdicts differ from the single-lane dispatcher's")
    placed = mesh is not None
    check(all(p[2] == (placed and p[0] > 1) for p in first), f"mesh ({key}): placement {first}")
    check(all(p[0] <= lanes for p in first), f"mesh ({key}): a superbatch of more lanes {first}")
    runs = [_mesh_run(v, blocks)[1] for _ in range(MESH_RUNS)]
    v.close()
    calls = traced_calls("mesh.run", [lambda: _mesh_run(holder["v"], blocks)],
                         "mesh_" + key.replace(" / ", "_").replace(" ", "_"), warm=make)
    holder["v"].close()
    med = statistics.median(runs)
    n_sigs = sum(len(b) for b in blocks)
    point = {
        "superbatches": len(first), "lanes_per_superbatch": sorted({p[1] for p in first}),
        "rows_per_superbatch": sorted({p[4] for p in first}), "placed": placed and ready,
        "simulated_lanes": lanes > 1 and not ready,
        "warm_superbatches": sum(p[3] for p in first),
        "median_ms": med, "sigs_per_s": n_sigs / med * 1e3,
        "traced_ms": calls[0]["call_ms"],
        "device_busy_ms": calls[0]["device_busy_ms"],
        "device_idle_share": 1 - calls[0]["device_busy_ms"] / calls[0]["call_ms"],
    }
    log(f"mesh ({key}): {len(first)} superbatches of {point['rows_per_superbatch']} rows, "
        f"{'placed lane by lane' if placed and ready else 'simulated lanes' if lanes > 1 else 'one lane'}; "
        f"{med:.2f} ms, {n_sigs / med * 1e3:.0f} signatures/s; busy "
        f"{calls[0]['device_busy_ms']:.3f} of {calls[0]['call_ms']:.2f} ms")
    return point, first


def _cap_blocks(sets: list) -> list:
    """MESH_CAP_LANES whole commits as jobs: V1's (cold), V2's and V3's
    (warm: their validator rows and set keys, as _job_blocks gives them)
    and V1's with TAMPER_AT tampered."""
    out = []
    for i, (sv, se) in enumerate(sets):
        b = EntryBlock.from_entries(se)
        if i:
            b.val_idx = np.arange(len(se), dtype=np.int32)
            b.epoch_key = sv.hash()
        out.append(b)
    bad = list(sets[0][1])
    p, m, s = bad[TAMPER_AT]
    bad[TAMPER_AT] = (p, m, tamper(s))
    return (out + [EntryBlock.from_entries(bad)])[:MESH_CAP_LANES]


def mesh_phase(light_wire: dict, ents: list, vals, split: tuple, dev) -> tuple:
    """(j3) The mesh dispatcher at bench.py multichip's shape: MESH_JOBS
    jobs of MESH_JOB_SIGS signatures from three sets (two warm) at
    mesh_lanes 1, 2 and 4 (lane_bucket MESH_JOB_SIGS) on the
    per-signature kernels (the default) and on the op-graph path
    (TM_TPU_PALLAS=0): each job's verdicts equal the single-lane
    dispatcher's; the superbatches, signatures a second (median of
    MESH_RUNS), and the card's busy time and idle share of a traced run.
    One card: lanes above 1 are simulated lanes on the default mesh; then
    Mesh((cuda:0,) * lanes) places them lane by lane on the card. Then
    the default lane capacity: MESH_CAP_LANES whole commits in one
    superbatch of MESH_CAP_LANES x BUCKETS[-1] rows, on both families.
    Then the mixed committee of N_VALIDATORS through
    prepare_commit_scheme_split on a two-lane dispatcher of the default
    lane capacity: its two blocks in one superbatch of two segments of
    BUCKETS[-1] rows, the sequential path's blame. Returns (the stats,
    the launches of the valid runs)."""
    blocks, sets = _job_blocks(light_wire, ents, vals)
    single = pipeline.shared_verifier(dev)
    want = [single.submit(b).result(timeout=600) for b in blocks]
    bad = [(i, np.nonzero(~w)[0].tolist()) for i, w in enumerate(want) if not w.all()]
    check(bad == [(MESH_TAMPER[0], [MESH_TAMPER[1]])],
          f"the single-lane dispatcher rejects {bad}")
    cap_blocks = _cap_blocks(sets)
    cap_want = [single.submit(b).result(timeout=600) for b in cap_blocks]
    bad = [(i, np.nonzero(~w)[0].tolist()) for i, w in enumerate(cap_want) if not w.all()]
    check(bad == [(MESH_CAP_LANES - 1, [TAMPER_AT])],
          f"the single-lane dispatcher rejects {bad} of the whole commits")
    cap = mesh_pack.lane_cap()
    out = {"jobs": MESH_JOBS, "job_sigs": MESH_JOB_SIGS, "points": {}}
    kernels.reset_launches()
    for family, pallas in (("per-signature", "1"), ("op-graph", "0")):
        with env("TM_TPU_PALLAS", pallas):
            for lanes in MESH_LANES:
                for placed in ((False, True) if lanes > 1 else (False,)):
                    key = f"{family} / {lanes} lanes" + (" / placed" if placed else "")
                    out["points"][key], _ = _mesh_point(
                        key, dev, lanes, MESH_JOB_SIGS,
                        sharded.Mesh([dev] * lanes) if placed else None, blocks, want)
            key = f"{family} / {MESH_CAP_LANES} lanes / default cap"
            out["points"][key], plans = _mesh_point(key, dev, MESH_CAP_LANES, None, None,
                                                    cap_blocks, cap_want)
            check([p[4] for p in plans] == [MESH_CAP_LANES * cap],
                  f"mesh ({key}): superbatches {plans}, wanted one of {MESH_CAP_LANES} x {cap} "
                  "rows")
            out["points"][key]["jobs"] = [len(b) for b in cap_blocks]
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    for name in ("k1_decompress", "k2_table", "k3_ladder", "sha512_challenge", "og_verify",
                 "og_verify_cached"):
        check(launches.get(name, 0) > 0, f"the mesh runs never launched {name}")

    # the mixed committee: two blocks, one superbatch of two segments
    svals, scommit = split
    needed = svals.total_voting_power() * 2 // 3
    kinds = [isinstance(v.pub_key, ed25519.PubKey) for v in svals.validators]
    first_secp = kinds.index(False, SPLIT_TAMPER)
    tampered = (first_secp, kinds.index(True, first_secp))
    bad = Commit(scommit.height, scommit.round, scommit.block_id, list(scommit.signatures))
    for i in tampered:
        cs = bad.signatures[i]
        bad.signatures[i] = dataclasses.replace(cs, signature=tamper(cs.signature))
    try:
        validation._verify_commit_single(CHAIN_ID, svals, bad, needed,
                                         validation._ignore_not_for_block,
                                         validation._count_all, False, True)
        raise SmokeFailure("the sequential path accepted the tampered mixed commit")
    except ValueError as e:
        blame = str(e)
    check(blame.startswith(f"wrong signature (#{first_secp})"),
          f"the sequential path blamed {blame:.40}, not #{first_secp}")
    split_ms = {}
    for label, commit, expect in (("valid", scommit, None), ("tampered", bad, blame)):
        t = time.perf_counter()
        blocks2, conclude = validation.prepare_commit_scheme_split(CHAIN_ID, svals, commit, needed)
        prep_ms = (time.perf_counter() - t) * 1e3
        check([b.scheme for b in blocks2] == ["ed25519", "secp256k1"],
              "the split gave blocks of schemes " + str([b.scheme for b in blocks2]))
        v = pipeline.AsyncBatchVerifier(dev, mesh_lanes=2)
        seen = []
        try:
            t = time.perf_counter()
            futs = submit_together(v, blocks2, seen)
            rows = np.concatenate([f.result(timeout=600) for f in futs])
            split_ms[label] = {"prep_ms": prep_ms, "verify_ms": (time.perf_counter() - t) * 1e3}
        finally:
            v.close()
        check([[(s, len(b)) for s, b, _ in sb.parts] for sb, _ in seen]
              == [[("ed25519", cap), ("secp256k1", cap)]],
              "the mixed committee did not land in one superbatch of two segments of "
              f"{cap} rows: {[[(s, len(b)) for s, b, _ in sb.parts] for sb, _ in seen]}")
        try:
            conclude(rows)
            got = None
        except ValueError as e:
            got = str(e)
        check(got == expect, f"the split's conclude gave {got!s:.80}, the sequential path "
              f"{expect!s:.80}")
    # the mesh points' launches and the mixed committee's (its secp256k1
    # segment runs secp_verify)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(launches.get("secp_verify", 0) > 0, "the mixed committee never launched secp_verify")
    out["split"] = {"validators": list(SPLIT_VALIDATORS),
                    "rows": [len(b) for b in blocks2], "segment_rows": cap,
                    "tampered": list(tampered), "blame": blame[:24], "ms": split_ms}
    log(f"mesh: the mixed committee's {[len(b) for b in blocks2]} rows in one superbatch of "
        f"two segments of {cap} rows (prep {split_ms['valid']['prep_ms']:.1f} ms, verify "
        f"{split_ms['valid']['verify_ms']:.1f} ms); rows {list(tampered)} tampered, "
        f"#{first_secp} blamed as the sequential path does")
    return out, launches


def tally_record(ins: list, stats: dict, launches: int) -> dict:
    """commit_tally's record at the one-shard commit's shape (10,240
    rows): the kernel's own device time (`ms`, the median interval of
    commit_tally_kernel in torch.profiler traces of KERNEL_REPS calls,
    `traced_launches` the launches seen),
    the wrapper's CUDA-event ms (`wrapper_ms`: its checks, the output's
    zero fill and the launch), its bound (bytes: each input read once,
    the 40 output bytes written once), the plain version's ms and the
    PyTorch expression's (the one-line call that computes it: the masked
    power sum and the count)."""
    valid, live, power = ins

    def library():
        ok = (valid != 0) & (live != 0)
        return torch.cat([(ok[:, None] * power).sum(0), ((live != 0) & (valid == 0)).sum()[None]])

    def wrapper():
        return sharded.commit_tally(valid, live, power)

    ms, traced = kernel_trace_ms(wrapper, "commit_tally_kernel", KERNEL_REPS, "commit_tally")
    wrapper_ms = event_ms(wrapper, KERNEL_REPS)
    lib_ms = event_ms(library, KERNEL_REPS)
    check(library().tolist() == wrapper().tolist(),
          "the PyTorch expression disagrees with commit_tally")
    io_bytes = sum(t.nbytes for t in ins) + 8 * sharded.TALLY_WORDS
    bound_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    source, replaces = KERNELS["commit_tally"]
    log(f"timing: commit_tally kernel {ms:.4f} ms (median of {traced} traced launches), "
        f"wrapper {wrapper_ms:.4f} ms "
        f"(events) over {live.shape[0]} rows; bound {bound_ms:.5f} ms ({io_bytes} B); the "
        f"PyTorch expression {lib_ms:.4f} ms")
    return {"name": "commit_tally", "route": "cuda",
            "source": f"tendermint_tpu_torch/csrc/{source}", "replaces": replaces, "ms": ms,
            "wrapper_ms": wrapper_ms, "traced_launches": traced,
            "bound_ms": bound_ms, "pct_of_bound": 100 * bound_ms / ms, "bound_by": "bytes",
            "library_ms": lib_ms, "units": int(live.shape[0]), "bytes": io_bytes,
            "launches": launches, "max_abs_err": stats["commit_tally"]["max_abs_err"],
            "plain_ms": stats["commit_tally"]["plain_ms"]}



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
        t = time.perf_counter()
        header_wire = build_header_chain(pool)
        header_sign_s = time.perf_counter() - t
        log(f"data: config #5's chain ({HEADERS + 1} headers of {HEADER_VALS} validators, "
            f"{(HEADERS + 1) * HEADER_VALS} signatures) built and signed in "
            f"{header_sign_s:.1f} s by {workers} processes")
        t = time.perf_counter()
        secp_vals, secp_commit = build_secp_commit(pool)
        secp_sign_s = time.perf_counter() - t
        t = time.perf_counter()
        mixed_ents = build_mixed(pool)
        mixed_sign_s = time.perf_counter() - t
        log(f"data: {SECP_VALIDATORS}-validator secp256k1 commit signed in {secp_sign_s:.1f} s, "
            f"config #4 ({'+'.join(map(str, MIXED))} signatures) in {mixed_sign_s:.1f} s, by "
            f"{workers} processes")
        bls_data = build_bls_data(pool)
    t = time.perf_counter()
    split = build_split_committee(vals, commit, secp_vals, secp_commit)
    log(f"data: the mixed committee ({'+'.join(map(str, SPLIT_VALIDATORS))} ed25519 and "
        f"secp256k1 validators, their signatures from slices (a) and (g)) built in "
        f"{time.perf_counter() - t:.1f} s")
    secp_wire = Commit.decode(secp_commit.encode())
    secp_ents = commit_entries(secp_commit, secp_vals)
    secp_table_pub = np.concatenate([
        np.frombuffer(b"".join(sorted({p for p, _, _ in secp_edge_entries()})), np.uint8)
        .reshape(-1, 33),
        secp_vals.secp256k1_columns()[0],
    ])
    table_pub = np.concatenate([
        np.frombuffer(b"".join(p for p, _, _ in edge), np.uint8).reshape(-1, 32),
        vals.ed25519_columns()[0],
    ])

    t = time.perf_counter()
    host_stats = host_phase(vals, wire["ed25519"], EntryBlock.from_entries(sr_ents))
    log(f"host phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    kstats = kernel_phase(inputs, sr_in, table_pub, dev)
    og_kernel_phase(kstats, inputs, dev)
    secp_battery = secp_kernel_phase(kstats, secp_ents, secp_table_pub, dev)["battery"]
    log(f"kernel phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    bls_codes_h1 = bls_kernel_phase(kstats, dev)
    log(f"bls kernel phase (h1): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    tally_in = tally_kernel_phase(kstats, dev)
    log(f"tally kernel phase (j1): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    launches = slice_phase(vals, wire["ed25519"], sets["sr25519"][0], wire["sr25519"], dev)
    log(f"slice phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    og_launches = opgraph_phase(vals, wire["ed25519"], dev)
    log(f"op-graph phase (i): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    light = light_phase(light_wire, dev)
    log(f"light phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    disp = dispatcher_phase(vals, wire["ed25519"], ents, light_wire, header_wire, dev)
    log(f"dispatcher phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    secp, secp_launches = secp_phase(secp_vals, secp_wire, mixed_ents, ents, secp_battery, dev)
    log(f"secp256k1 phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    bls, bls_launches = bls_phase(bls_data, dev)
    log(f"bls phase (h2, h3): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    shard_stats, shard_launches = sharded_phase(vals, ents, dev)
    log(f"sharded phase (j2): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    mesh_stats, mesh_launches = mesh_phase(light_wire, ents, vals, split, dev)
    log(f"mesh phase (j3): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    paths = {}
    for p in PATHS:
        key_type = PATH_SETUP[p][4]
        paths[p] = time_path(p, sets[key_type][0], wire[key_type], sets[key_type][1], dev)
    records = kernel_timing(vals, EntryBlock.from_entries(ents),
                            EntryBlock.from_entries(sr_ents), secp_vals, secp_ents, dev,
                            sm_clock_hz)
    light["timing"] = light_timing(light_wire, dev)
    secp["timing"] = secp_timing(secp_vals, secp_wire, dev)
    records += bls_timing(bls_data, kstats, dev, sm_clock_hz)
    tally = tally_record(tally_in, kstats, shard_launches["commit_tally"])
    log(f"timing phase: {time.perf_counter() - t:.1f} s")
    log("paths (median ms): " + ", ".join(
        f"{p} {s['verify_commit_ms']:.2f} e2e / {s['device_busy_ms'] or 0:.3f} busy"
        for p, s in paths.items()))
    for r in records:
        # slices (a)-(d), config #5's first run in slice (f); the secp256k1
        # kernels' in slices (g1)-(g4) and (j3)'s mixed committee; the
        # op-graph kernels' in slice (i), the shards of (j2) and the mesh
        # runs of (j3)
        if r["name"].startswith("secp_"):
            r["launches_by_slice"] = {
                **{k: v.get(r["name"], 0) for k, v in secp_launches.items()},
                "j3": mesh_launches.get(r["name"], 0)}
            r["launches"] = sum(r["launches_by_slice"].values())
        elif r["name"] in ("sha512_challenge", "og_verify", "og_verify_cached"):
            r["launches_by_slice"] = {
                "i": og_launches[r["name"]], "j2": shard_launches.get(r["name"], 0),
                "j3": mesh_launches.get(r["name"], 0)}
            r["launches"] = sum(r["launches_by_slice"].values())
        elif r["name"].startswith("bls_"):
            r["launches"] = bls_launches.get(r["name"], 0)
        else:
            r["launches"] = launches[r["name"]] + disp["headers"]["launches"].get(r["name"], 0)
        r["max_abs_err"] = kstats[r["name"]]["max_abs_err"]
        r["plain_ms"] = kstats[r["name"]]["plain_ms"]
        r.update(resources.get(r["name"], {}))
    tally.update(resources.get("commit_tally", {}))
    records.append(tally)
    log("summary: " + json.dumps({"paths": paths, "host": host_stats}))
    light.update(card=card, n_validators=N_VALIDATORS, signatures=n_light,
                 signing_s=light_sign_s)
    print(json.dumps({"light": light}), flush=True)
    disp.update(card=card, header_signing_s=header_sign_s)
    print(json.dumps({"dispatcher": disp}), flush=True)
    secp.update(card=card, n_validators=SECP_VALIDATORS, signing_s=secp_sign_s,
                mixed_signing_s=mixed_sign_s)
    print(json.dumps({"secp": secp}), flush=True)
    bls.update(card=card, n_validators=BLS_VALIDATORS, h1_codes=bls_codes_h1,
               derive_s=bls_data["derive_s"], status_s=bls_data["status_s"],
               signing_s=bls_data["sign_s"])
    print(json.dumps({"bls": bls}), flush=True)
    mesh_stats.update(card=card, sharded=shard_stats, sharded_launches=shard_launches,
                      mesh_launches=mesh_launches)
    print(json.dumps({"mesh": mesh_stats}), flush=True)
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
