"""Lane packing of the mesh dispatcher: many verification jobs packed into
the lanes of one superbatch a launch.

Counterpart: tendermint_tpu/ops/mesh.py (lane_cap :134, _bucket_for,
_next_pow2, _pow2_floor, Lane :169, MeshPlan :188, pack_jobs :260,
_secp_pad_row :335, pad_block :355, _warm_entry :390, SchemeSuperBlock
:409, build_superblock :438, _prepare_mixed_superbatch :505,
prepare_superbatch :578). In mesh mode (ops/pipeline.AsyncBatchVerifier
with mesh_lanes >= 1) the dispatcher's coalescer drains up to lanes x
lane capacity signatures and packs whole jobs:

    lane        one shard's contiguous lane_bucket rows of the
                superbatch, holding whole jobs of ONE epoch key and ONE
                scheme (jobs of different sets land in different lanes)
    pad rows    short lanes are completed with rows that verify under
                any challenge (ed25519: A = R = the identity, s = 0;
                secp256k1: a fixed valid signature by the generator), a
                warm lane's taking the table's padding column
    superbatch  the lanes one after another, n_lanes a power of two
    demux       each job's verdicts are a global row range of the one
                verdict row

The packing is host bookkeeping (numpy and EntryBlock). prepare_superbatch
is the host stage of a superbatch: it returns a MeshBatch (the
dispatcher's prepared-batch contract: args, bucket, launch, conclude)
with its lane placement. Kernel choice follows the reference:

- with backend.use_pallas() on, the per-signature K1 -> K2 -> K3
  (uncached: the reference's Pallas face ships the keys);
- otherwise the op-graph check, with sha512_challenge where
  backend.device_hash_for holds, og_verify_cached when the whole pack
  shares one warm epoch;
- a secp256k1 pack, and each segment of a mixed pack, on the dispatcher's
  card with the port's secp256k1 kernels and the op-graph check.

An ed25519 pack of more than one lane is placed lane by lane on the
dispatcher's mesh when the mesh has an entry for each lane
(sharded.mesh_ready); otherwise the whole superbatch launches on the
dispatcher's card as simulated lanes, with the same kernels and
verdicts. The RLC path does not run in the mesh: a lane's verdicts are
per signature (reference :594).

The reference's TM_TPU_MESH_LANE_BUCKET is the dispatcher's lane_bucket
argument (lane_cap), with the same clamp; its (priority, seq) pack order
is arrival order here (one priority class, ops/pipeline.py). Not ported
(ROADMAP queue 1): the BLS12-381 aggregation lanes (_lane_width for
bls12381 :103, AggBlock pad lanes, the per-lane BLS segment :520-535);
a mesh-mode dispatcher refuses an AggBlock at submit.
"""

from __future__ import annotations

import functools
import hashlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import backend, epoch_cache, secp_verify, sharded
from . import ed25519_verify as og
from . import verify as per_sig
from .entry_block import EntryBlock, block_concat

# the single-device bucket ladder (backend.BUCKETS)
_BUCKETS = backend.BUCKETS
# the smallest lane capacity lane_cap allows: the secp256k1 lane's fine
# bucket floor (backend.SECP_BUCKETS)
_LANE_BUCKET_FLOOR = 16

BLS_LANES_ITEM = "ROADMAP.md queue 1, BLS12-381 aggregation lanes in the mesh packer"


def lane_cap(lane_bucket: Optional[int] = None) -> int:
    """The most signatures one lane may hold (whole jobs; submit chunks
    larger jobs at it): `lane_bucket` clamped into [16, BUCKETS[-1]], or
    BUCKETS[-1] (reference :134)."""
    if lane_bucket:
        return min(max(int(lane_bucket), _LANE_BUCKET_FLOOR), _BUCKETS[-1])
    return _BUCKETS[-1]


def _bucket_for(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class Lane:
    """One shard's packed jobs: one epoch key, one scheme, whole jobs,
    live rows at most the plan's lane_bucket."""

    __slots__ = ("key", "scheme", "jobs", "n")

    def __init__(self, key: Optional[bytes], scheme: str = "ed25519"):
        self.key = key
        self.scheme = scheme
        self.jobs: List = []  # objects with an `.entries` EntryBlock
        self.n = 0

    def add(self, job) -> None:
        self.jobs.append(job)
        self.n += len(job.entries)


class MeshPlan:
    """A packed superbatch: `lanes` live lanes (fewer than n_lanes when the
    rest are pure padding), each padded to lane_bucket rows; empty_jobs
    resolve as zero-width spans without a lane."""

    __slots__ = ("lanes", "lane_bucket", "n_lanes", "empty_jobs")

    def __init__(self, lanes: List[Lane], max_lanes: int, lane_bucket: Optional[int] = None,
                 cap: Optional[int] = None):
        self.lanes = lanes
        self.empty_jobs: List = []
        self.lane_bucket = lane_bucket or min(
            _bucket_for(max((l.n for l in lanes), default=1)), lane_cap(cap))
        # a power-of-two lane count, floored at the dispatcher's lanes
        self.n_lanes = min(_next_pow2(max(len(lanes), 1)), _pow2_floor(max(max_lanes, 1)))

    @property
    def bucket(self) -> int:
        """The superbatch's rows: n_lanes * lane_bucket."""
        return self.n_lanes * self.lane_bucket

    @property
    def live(self) -> int:
        return sum(l.n for l in self.lanes)

    @property
    def pad(self) -> int:
        return self.bucket - self.live

    def epoch_key(self) -> Optional[bytes]:
        """The one epoch key of every lane, or None when they differ."""
        keys = {l.key for l in self.lanes}
        return next(iter(keys)) if len(keys) == 1 else None

    def schemes(self) -> List[str]:
        """The plan's schemes in segment order (ed25519 first: pure padding
        lanes extend the first segment)."""
        found = {l.scheme for l in self.lanes}
        return [s for s in ("ed25519", "secp256k1")
                if s in found or (s == "ed25519" and not found)]


def pack_jobs(jobs, max_lanes: int, cap: Optional[int] = None) -> Tuple[MeshPlan, List]:
    """First-fit pack of `jobs` (each with an `.entries` EntryBlock) into
    at most max_lanes (floored to a power of two) lanes of one epoch key
    and one scheme, each of at most `cap` signatures, in the order given
    (arrival order: the reference's (priority, seq) order with one
    class). A job joins a lane only if the fused lane stays in its bucket
    or nearly fills the next (the coalescer's peel rule). Returns the
    plan and the jobs that fit no lane (held over for the next
    superbatch). A job larger than cap raises: submit chunks first."""
    cap = cap or lane_cap()
    max_lanes = _pow2_floor(max(max_lanes, 1))
    lanes: List[Lane] = []
    held: List = []
    empty: List = []
    for job in jobs:
        n = len(job.entries)
        if n > cap:
            raise ValueError(f"job of {n} sigs exceeds the {cap}-sig lane capacity")
        if n == 0:
            empty.append(job)
            continue
        key = job.entries.epoch_key
        scheme = getattr(job.entries, "scheme", "ed25519")

        def fits(l, n=n, key=key, scheme=scheme):
            if l.key != key or l.scheme != scheme or l.n + n > cap:
                return False
            b = _bucket_for(l.n + n)
            if b == _bucket_for(l.n):
                return True
            return b - (l.n + n) <= max(b // 8, 1024)

        lane = next((l for l in lanes if fits(l)), None)
        if lane is None:
            if len(lanes) >= max_lanes:
                held.append(job)
                continue
            lane = Lane(key, scheme)
            lanes.append(lane)
        lane.add(job)
    plan = MeshPlan(lanes, max_lanes, cap=cap)
    plan.empty_jobs = empty
    return plan, held


@functools.lru_cache(maxsize=1)
def _secp_pad_row() -> Tuple[bytes, bytes]:
    """The secp256k1 padding row's (pub33, sig64): the lower-S signature
    of the empty message by the key 1 with the nonce 1 (r = Gx mod n,
    s = +-(e + r) mod n), which verifies."""
    n_ord = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
    gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
    e = int.from_bytes(hashlib.sha256(b"").digest(), "big") % n_ord
    r = gx % n_ord
    s = (e + r) % n_ord
    if s > n_ord // 2:
        s = n_ord - s
    pub = bytes([2]) + gx.to_bytes(32, "big")  # compressed G; Gy is even
    return pub, r.to_bytes(32, "big") + s.to_bytes(32, "big")


def pad_block(n: int, ep=None, scheme: str = "ed25519") -> EntryBlock:
    """n padding rows as an EntryBlock. ed25519: A = R = the identity
    encoding, s = 0, the empty message; secp256k1: _secp_pad_row. With a
    warm epoch entry `ep` the rows take its padding column (vp - 1) and
    its key, so a warm superbatch stays warm."""
    if scheme not in ("ed25519", "secp256k1"):
        raise ValueError(f"no {scheme} lanes in the mesh packer yet ({BLS_LANES_ITEM})")
    pub = np.zeros((n, 32), dtype=np.uint8)
    sig = np.zeros((n, 64), dtype=np.uint8)
    pub_aux = None
    if scheme == "secp256k1":
        pad_pub, pad_sig = _secp_pad_row()
        pub_aux = np.full((n,), pad_pub[0], dtype=np.uint8)
        if n:
            pub[:] = np.frombuffer(pad_pub[1:], dtype=np.uint8)
            sig[:] = np.frombuffer(pad_sig, dtype=np.uint8)
    elif n:
        pub[:, 0] = 1
        sig[:, 0] = 1  # R = the identity encoding; s stays 0
    val_idx = epoch_key = None
    if ep is not None:
        val_idx = np.full((n,), ep.vp - 1, dtype=np.int32)
        epoch_key = ep.key
    return EntryBlock(pub, sig, b"", np.zeros(n + 1, dtype=np.int64), val_idx=val_idx,
                      epoch_key=epoch_key, scheme=scheme, pub_aux=pub_aux)


def _warm_entry(plan: MeshPlan):
    """The epoch entry of the plan's one key when the cache holds it (an
    ed25519 entry: the probe carries no scheme, as the reference's)."""
    key = plan.epoch_key()
    if key is None:
        return None

    class _Probe:
        epoch_key = key
        val_idx = True

    return epoch_cache.lookup(_Probe())


class SchemeSuperBlock:
    """A mixed-scheme superbatch: one contiguous EntryBlock segment a
    scheme with its global row offset (EntryBlock.concat refuses to mix
    schemes); its verdicts are the segments' one after another."""

    __slots__ = ("parts", "_n")

    def __init__(self, parts: List[Tuple], n: int):
        self.parts = parts  # [(scheme, EntryBlock, row_offset), ...]
        self._n = n

    def __len__(self) -> int:
        return self._n


def build_superblock(plan: MeshPlan) -> Tuple[object, List[Tuple]]:
    """The plan's rows, exactly plan.bucket (live jobs, per-lane padding,
    pure padding lanes), and the demux spans [(job, row_offset, n)]. A
    one-scheme plan gives one EntryBlock; a mixed plan a SchemeSuperBlock
    whose segments hold each scheme's lanes together (pure padding lanes
    extend the first)."""
    ep = _warm_entry(plan)
    lb = plan.lane_bucket
    order = plan.schemes()
    seq: List[Tuple] = []
    for s in order:
        seq.extend((l, s) for l in plan.lanes if l.scheme == s)
        if s == order[0]:
            seq.extend((None, s) for _ in range(plan.n_lanes - len(plan.lanes)))
    segs: List[Tuple] = []  # [(scheme, [blocks])]
    spans: List[Tuple] = []
    base = 0
    for lane, s in seq:
        blocks: List = []
        off = 0
        if lane is not None:
            for job in lane.jobs:
                n = len(job.entries)
                spans.append((job, base + off, n))
                if n:
                    blocks.append(job.entries)
                off += n
        if off < lb:
            blocks.append(pad_block(lb - off, ep, s))
        if segs and segs[-1][0] == s:
            segs[-1][1].extend(blocks)
        else:
            segs.append((s, blocks))
        base += lb
    for job in plan.empty_jobs:
        spans.append((job, 0, 0))
    if len(segs) == 1:
        return EntryBlock.concat(segs[0][1]), spans
    parts: List[Tuple] = []
    off = 0
    for s, blocks in segs:
        blk = block_concat(blocks)
        parts.append((s, blk, off))
        off += len(blk)
    return SchemeSuperBlock(parts, off), spans


# -- the host stage of a superbatch ------------------------------------------------


class MeshBatch:
    """A prepared superbatch, the dispatcher's prepared-batch contract:
    `args` (the host arrays), `bucket` (rows), `launch(dev_args)` (the
    arguments of some rows as tensors on one device -> their (rows,)
    int32 verdicts there, on the current stream: the whole superbatch, or
    one lane), `conclude(row)` (the superbatch's verdict row read back ->
    (bucket,) bool), and the lane placement: `placement`
    (sharded.Placement) and `host` (its per-device arrays), or None for
    the whole superbatch on the dispatcher's card."""

    __slots__ = ("args", "bucket", "launch", "placement", "host")

    def __init__(self, args: tuple, bucket: int, launch, placement=None):
        self.args = args
        self.bucket = bucket
        self.launch = launch
        self.placement = placement
        self.host = None if placement is None else placement.split(args)

    def conclude(self, row: np.ndarray) -> np.ndarray:
        return np.asarray(row).reshape(-1)[: self.bucket].astype(bool)


def _as_int32(launch):
    def run(dev_args) -> torch.Tensor:
        return launch(dev_args).reshape(-1).to(torch.int32)

    return run


def _segment(scheme: str, blk) -> tuple:
    """(args, launch) of one segment of a mixed superbatch on the
    dispatcher's card: the secp256k1 kernels (cached when the segment's
    set is warm) or the op-graph check."""
    if scheme == "secp256k1":
        batch = secp_verify.prepare_batch(blk, epoch_cache.lookup(blk), bucket=len(blk))
    else:
        batch = og.prepare_batch(blk, backend.device_hash_for(blk), bucket=len(blk))
    return batch.args, _as_int32(batch.launch)


def _prepare_mixed_superbatch(sb: SchemeSuperBlock, bucket: int) -> MeshBatch:
    """A mixed superbatch (reference :505): each segment's kernel and
    arguments behind one launch, which slices the flat argument tuple
    back per segment and concatenates the verdicts in segment order: one
    dispatch for the whole mixed commit."""
    segs: List[Tuple] = []
    flat: List = []
    for scheme, blk, _off in sb.parts:
        args, launch = _segment(scheme, blk)
        segs.append((launch, len(flat), len(flat) + len(args)))
        flat.extend(args)

    def launch(dev_args) -> torch.Tensor:
        return torch.cat([fn(dev_args[lo:hi]) for fn, lo, hi in segs])

    return MeshBatch(tuple(flat), bucket, launch)


def prepare_superbatch(block, plan: MeshPlan, mesh: Optional[sharded.Mesh] = None) -> MeshBatch:
    """The host stage of a superbatch (reference :578): the MeshBatch of
    `block` (build_superblock's) by the kernel choice of the module
    docstring, placed lane by lane on `mesh` when it is an ed25519 pack
    of more than one lane and sharded.mesh_ready(plan.n_lanes, mesh)."""
    bucket = plan.bucket
    if len(block) != bucket:
        raise ValueError(f"superblock is {len(block)} rows, plan says {bucket}")
    if isinstance(block, SchemeSuperBlock):
        return _prepare_mixed_superbatch(block, bucket)
    if block.scheme == "secp256k1":
        batch = secp_verify.prepare_batch(block, epoch_cache.lookup(block), bucket=bucket)
        return MeshBatch(batch.args, bucket, _as_int32(batch.launch))
    use_mesh = (plan.n_lanes > 1 and mesh is not None
                and sharded.mesh_ready(plan.n_lanes, mesh))
    if backend.use_pallas():
        args = per_sig.prepare_compact(block, bucket)
        kind, launch = "pallas", sharded.per_sig_step
    else:
        batch = og.prepare_batch(block, backend.device_hash_for(block), bucket=bucket)
        args = batch.args
        if batch.ep is None:
            kind = "device_hash" if batch.device_hash else "host_hash"
            launch = sharded.mesh_valid_fn(batch.device_hash)
        else:
            kind = "cached_device_hash" if batch.device_hash else "cached"
            launch = sharded.mesh_valid_fn_cached(batch.ep, batch.device_hash)
    placement = None
    if use_mesh:
        placement = sharded.mesh_arg_shardings(mesh.prefix(plan.n_lanes), kind, len(args))
    return MeshBatch(args, bucket, launch, placement)
