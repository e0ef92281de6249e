"""The op-graph ed25519 path: one per-signature ZIP-215 kernel a batch,
with the challenges hashed on the card or on the host.

Counterpart: tendermint_tpu/ops/ed25519_verify.py (verify_kernel :152,
verify_kernel_cached :273 and their device-hash variants :290, :307) and
the op-graph branch of the reference's backend and dispatcher
(backend._verify_batch_direct :921-951, prepare_batch_device_hash :731,
prepare_batch_cached_device_hash :406, cached_kernel :452;
pipeline._prepare :604-628), the path the JAX package takes when Pallas
is off (TM_TPU_PALLAS=0; ops/backend.py picks it). Each signature is
checked on its own:

    accept iff A and R decompress (ZIP-215), s < L (host flag), and
    [8]([s]B + [k](-A) - R) is the identity

Two kernels (csrc/ed25519_verify.cu), each with its plain PyTorch
version here, take raw (n, 32) uint8 rows and give one int32 verdict a
signature:

  og_verify         A, R, s, k rows and s_ok: decompress A and R, the
                    16-entry table [s2]B + [k2](-A), the 127-step joint
                    ladder, - R, [8], the identity test, in one launch
  og_verify_cached  the same with A from the set's epoch table
                    (ops/epoch_cache.py coords_tables) through each
                    signature's column

k = SHA-512(R || A || M) mod L comes from the card (ops/sha512.py
sha512_challenge, over R || A || M blocks the host lays out, from the
fused commit prep's RAM columns where it built them) or, when
TM_TPU_HOST_HASH=1 or a message exceeds commit_prep.DEVICE_HASH_MAX_MSG,
from the host library (ops/host.ed25519_challenges_buf):
ops/backend.device_hash_for decides per batch, as the reference does.
The device-hash variants are the composition sha512_challenge ->
og_verify{,_cached}. The reference's 20 x 13-bit limbs (its own ops/fe.py,
batch first) are the port's ops/fe.py limbs, batch last: the kernels take
raw bytes, so no limb layout crosses the host boundary.

A batch runs in three stages, as ops/verify.py's: prepare_batch (host
only), launch_batch (device tensors in, the (bucket,) int32 verdicts out,
on the current stream) and conclude_batch; the dispatcher
(ops/pipeline.py) runs them on its threads and verify_batch_og on the
caller's. Their work is marked by record_function spans og.prep,
og.gather on a warm epoch, og.kernels; verify_batch_og adds og.h2d and
og.d2h. Buckets are the reference's (128, 1024, 10240). A wrapper runs
the plain version for CPU tensors and launches its kernel for CUDA
tensors, counting launches in kernels.LAUNCHES.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from . import epoch_cache, fe, kernels, packing, point
from . import sha512 as _sha
from . import verify as per_sig

BUCKETS = per_sig.BUCKETS  # backend.BUCKETS; the last is the chunk size


def bucket_for(n: int) -> int:
    """Signatures a batch of n pads to (backend._bucket_for)."""
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


# -- plain versions -----------------------------------------------------------


def _check(a, neg_r, s_rows, k_rows):
    """[8]([s]B + [k](-A) - R) == O per signature, (1, n) bool, for the
    extended points A and -R: the table of K2 (verify.k2_table_plain over
    A's point), the 127 iterations of two doubles and a Niels add (the
    last one making T), + (-R), three doubles, X == 0 and Y == Z."""
    n = s_rows.shape[0]
    coords = torch.zeros((per_sig.COORD_ROWS, n), dtype=torch.int32, device=s_rows.device)
    for c in range(4):
        coords[point.slot_rows(0, c)] = a[c]
    tbl = per_sig.k2_table_plain(coords)
    sdig = point.unpack_digits2_grouped(s_rows.T.to(torch.int32))
    kdig = point.unpack_digits2_grouped(k_rows.T.to(torch.int32))
    zero = torch.zeros((fe.NLIMBS, n), dtype=torch.int32, device=s_rows.device)
    one = fe.from_int(1, zero) + zero
    acc = (zero, one, one, zero)
    limb = torch.arange(fe.NLIMBS, device=s_rows.device)[:, None]
    for i in range(127):
        j = point.digit_row(126 - i)
        acc = point.point_double(point.point_double(acc, need_t=False))
        e = sdig[j] + 4 * kdig[j]
        ent = tuple(tbl.gather(0, ((e[None, :] * 4 + c) * 32) + limb) for c in range(4))
        acc = point.point_add_niels(acc, ent, need_t=i == 126)
    acc = point.point_add(acc, neg_r)
    for _ in range(3):
        acc = point.point_double(acc, need_t=False)
    return fe.is_zero(acc[0]) & fe.is_zero(fe.sub(acc[1], acc[2]))


def og_verify_plain(a_rows, r_rows, s_rows, k_rows, s_ok):
    """(n, 32) uint8 A, R, s, k rows and (n,) int32 s_ok -> (n,) int32
    verdicts. A and R decompress in one call, folded along the batch."""
    n = a_rows.shape[0]
    a_y, a_sign = point.unpack_limbs(a_rows.T.to(torch.int32))
    r_y, r_sign = point.unpack_limbs(r_rows.T.to(torch.int32))
    ok, pts = point.decompress(torch.cat([a_y, r_y], dim=1), torch.cat([a_sign, r_sign], dim=1))
    neg_r = point.point_neg(point.slice_point(pts, 1, n))
    eq = _check(point.slice_point(pts, 0, n), neg_r, s_rows, k_rows)
    return (ok[:, :n] & ok[:, n:] & (s_ok != 0)[None, :] & eq)[0].to(torch.int32)


def og_verify_cached_plain(ctbl, oktbl, idx, r_rows, s_rows, k_rows, s_ok):
    """og_verify_plain with A and its flag from the epoch table: ctbl
    (4 * 32, vp), oktbl (1, vp) int32, idx (n,) int32 each signature's
    column; only R decompresses."""
    cols = idx.to(torch.int64)
    a = tuple(ctbl[point.slot_rows(0, c)][:, cols] for c in range(4))
    r_y, r_sign = point.unpack_limbs(r_rows.T.to(torch.int32))
    ok_r, r = point.decompress(r_y, r_sign)
    eq = _check(a, point.point_neg(r), s_rows, k_rows)
    ok_a = oktbl[:, cols] != 0
    return (ok_a & ok_r & (s_ok != 0)[None, :] & eq)[0].to(torch.int32)


# -- kernel wrappers ----------------------------------------------------------


def _check_rows(dev, n, **rows) -> None:
    for name, t in rows.items():
        kernels.check_tensor(name, t, (n, 32), torch.uint8, dev)


def og_verify(a_rows, r_rows, s_rows, k_rows, s_ok) -> torch.Tensor:
    """The op-graph check (replaces ed25519_verify.verify_kernel :152);
    see og_verify_plain."""
    dev = kernels.device_of(s_ok)
    n = s_ok.shape[0]
    _check_rows(dev, n, a_rows=a_rows, r_rows=r_rows, s_rows=s_rows, k_rows=k_rows)
    kernels.check_tensor("s_ok", s_ok, (n,), torch.int32, dev)
    if dev.type == "cpu":
        return og_verify_plain(a_rows, r_rows, s_rows, k_rows, s_ok)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    kernels.launch("og_verify", a_rows, r_rows, s_rows, k_rows, s_ok, out, n)
    return out


def og_verify_cached(ctbl, oktbl, idx, r_rows, s_rows, k_rows, s_ok) -> torch.Tensor:
    """The op-graph check on a warm set (replaces
    ed25519_verify.verify_kernel_cached :273); see og_verify_cached_plain."""
    dev = kernels.device_of(s_ok)
    n = s_ok.shape[0]
    vp = ctbl.shape[-1]
    kernels.check_tensor("ctbl", ctbl, (epoch_cache.TABLE_ROWS, vp), torch.int32, dev)
    kernels.check_tensor("oktbl", oktbl, (1, vp), torch.int32, dev)
    kernels.check_tensor("idx", idx, (n,), torch.int32, dev)
    _check_rows(dev, n, r_rows=r_rows, s_rows=s_rows, k_rows=k_rows)
    kernels.check_tensor("s_ok", s_ok, (n,), torch.int32, dev)
    if dev.type == "cpu":
        return og_verify_cached_plain(ctbl, oktbl, idx, r_rows, s_rows, k_rows, s_ok)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    kernels.launch("og_verify_cached", ctbl, oktbl, idx, r_rows, s_rows, k_rows, s_ok, out, n,
                   vp)
    return out


def og_verify_device_hash(a_rows, r_rows, s_rows, hi, lo, counts, s_ok) -> torch.Tensor:
    """verify_kernel_device_hash (:307): k hashed on the card from the
    R || A || M blocks, then og_verify."""
    return og_verify(a_rows, r_rows, s_rows, _sha.sha512_challenge(hi, lo, counts), s_ok)


def og_verify_cached_device_hash(ctbl, oktbl, idx, r_rows, s_rows, hi, lo, counts,
                                 s_ok) -> torch.Tensor:
    """verify_kernel_cached_device_hash (:290): k hashed on the card, then
    og_verify_cached."""
    k_rows = _sha.sha512_challenge(hi, lo, counts)
    return og_verify_cached(ctbl, oktbl, idx, r_rows, s_rows, k_rows, s_ok)


# -- host prep and the batch path ---------------------------------------------


class OgBatch:
    """One prepared op-graph batch of at most BUCKETS[-1] signatures: the
    host arrays to copy to the device (`args`, in launch order), its
    bucket, the epoch entry of a warm set (None when cold) and whether k
    hashes on the card."""

    __slots__ = ("entries", "bucket", "ep", "device_hash", "args")

    def __init__(self, entries, bucket: int, ep, device_hash: bool, args: tuple):
        self.entries = entries
        self.bucket = bucket
        self.ep = ep
        self.device_hash = device_hash
        self.args = args

    def launch(self, dev_args) -> torch.Tensor:
        return launch_batch(self, dev_args)

    def conclude(self, row: np.ndarray) -> np.ndarray:
        return conclude_batch(self, row)


def prepare_batch(entries, device_hash: bool, bucket: int = None) -> OgBatch:
    """The host stage (numpy and the host library only; touches no CUDA).
    Rows padded to `bucket` (default bucket_for(n); the sharded verifiers
    and the mesh dispatcher give theirs, which may exceed BUCKETS[-1]):
    A = R = the identity, s = 0 (k = 0 on
    the host route; the identity pattern's hash on the card's), s_ok = 1.
    args, cold: (A, R, s rows, then k rows or the hash's (hi, lo, counts),
    s_ok); warm (ops/epoch_cache.lookup finds the set's table): the table
    columns in place of A. A device-hash batch takes the block's RAM
    columns where the fused prep built them (sha512.pad_ram_rows), else
    lays them out (pad_ram_block); a message too long for the layout
    raises ValueError (ops/backend.device_hash_for keeps such batches on
    the host route)."""
    n = len(entries)
    if bucket is None:
        if n > BUCKETS[-1]:
            raise ValueError(f"an op-graph batch holds at most {BUCKETS[-1]} signatures")
        bucket = bucket_for(n)
    elif n > bucket:
        raise ValueError(f"bucket {bucket} is below the batch's {n} signatures")
    ep = epoch_cache.lookup(entries)
    with record_function("og.prep"):
        if device_hash:
            pub, r_enc, s_enc = packing.pack_rows(entries, bucket)
            s_ok = packing.s_below_l(s_enc, n, bucket)
            hi, lo, counts = _sha.ram_words(entries, bucket)
            k_args = (_sha.as_int32(hi), _sha.as_int32(lo), counts)
        else:
            pub, r_enc, s_enc, k_enc, s_ok = packing.host_rows(entries, bucket)
            k_args = (k_enc,)
        first = pub if ep is None else epoch_cache.table_columns(entries, bucket, ep)
        args = (first, r_enc, s_enc) + k_args + (s_ok.astype(np.int32),)
    return OgBatch(entries, bucket, ep, device_hash, args)


def launch_batch(batch: OgBatch, dev_args) -> torch.Tensor:
    """The device stage: batch.args as tensors on one device -> the
    (bucket,) int32 verdicts there, launched on the current stream (a
    device-hash batch: sha512_challenge, then the check). A warm batch
    builds its epoch's table on first use on that device."""
    if batch.ep is None:
        with record_function("og.kernels"):
            fn = og_verify_device_hash if batch.device_hash else og_verify
            return fn(*dev_args)
    with record_function("og.gather"):  # builds the table once
        tables = batch.ep.coords_tables(dev_args[0].device)
    with record_function("og.kernels"):
        fn = og_verify_cached_device_hash if batch.device_hash else og_verify_cached
        return fn(*tables, *dev_args)


def conclude_batch(batch: OgBatch, row: np.ndarray) -> np.ndarray:
    """The verdict stage: the (bucket,) verdicts read back to the host ->
    (n,) bool, padding cut."""
    return np.asarray(row)[: len(batch.entries)].astype(bool)


def verify_batch_og(entries, *, device) -> np.ndarray:
    """EntryBlock of any size -> (n,) bool ZIP-215 verdicts,
    synchronously, in chunks of at most BUCKETS[-1] signatures on
    `device`: prepare_batch, the copy, launch_batch, the readback,
    conclude_batch. Whether k hashes on the card is decided once for the
    whole block (backend._verify_batch_direct :921)."""
    from .backend import device_hash_for

    device_hash = device_hash_for(entries)
    out = []
    for i in range(0, len(entries), BUCKETS[-1]):
        batch = prepare_batch(entries[i : i + BUCKETS[-1]], device_hash)
        with record_function("og.h2d"):
            dev_args = [torch.from_numpy(a).to(device) for a in batch.args]
        res = launch_batch(batch, dev_args)
        with record_function("og.d2h"):  # waits for the kernels
            row = res.cpu().numpy()
        out.append(conclude_batch(batch, row))
    return np.concatenate(out) if out else np.zeros((0,), dtype=bool)
