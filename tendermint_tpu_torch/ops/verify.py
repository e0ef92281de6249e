"""Per-signature ZIP-215 verification — one ladder per signature.

Counterpart: tendermint_tpu/ops/pallas_verify.py (prepare_compact,
verify_compact, prepare_compact_cached, verify_compact_cached and their
four kernels) and the per-signature branch of
backend._verify_batch_direct (backend.py:902-919), the path the JAX
package takes when RLC is off (TM_TPU_RLC=0). Each signature is checked
on its own:

    accept iff A and R decompress (ZIP-215: non-canonical y allowed),
    s < L (host flag), and [8]([s]B - [k]A) == [8]R

with k = SHA-512(R || A || M) mod L from the host. Verdicts are exact per
signature, so there is no blame pass. Three kernels run per batch, each
with a CUDA version (csrc/verify.cu) and a plain PyTorch version here:

  K1  k1_decompress  digits of s and k; decompression of A and R
      k1_decompress_cached  the same for a warm validator set: A and its
                     flag come from the epoch table (ops/epoch_cache.py)
                     through each signature's table column, only R
                     decompresses
  K2  k2_table       the 16-entry table [s2]B + [k2](-A), Niels form
  K3  k3_ladder      the 127-iteration ladder of 2 doubles and 1 Niels
                     add, then [8]acc == [8]R, ANDed with the two
                     decompression flags and s < L

The sr25519 path (ops/sr25519.py) reuses K2 and the ladder. Arrays keep
the JAX layout: (rows, n) with the signature last; the warm K1 reads its
per-signature rows row-major, (n, 32), as the host packs them, so the
JAX pipeline's device gather and transposes do not exist. A wrapper runs
the plain version for CPU tensors and launches its kernel for CUDA
tensors, counting launches in kernels.LAUNCHES. A batch runs in three
stages, plain functions the synchronous verify_batch_compact and the
asynchronous dispatcher (ops/pipeline.py) share: prepare_batch (host
only), launch_batch (device tensors in, the device verdicts out, on the
current stream) and conclude_batch. Their work is marked by
torch.profiler record_function spans: verify.prep, verify.gather on a
warm epoch, verify.kernels; the synchronous path adds verify.h2d and
verify.d2h.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..crypto import _edwards
from . import epoch_cache, fe, kernels, point

NL = fe.NLIMBS

BLOCK = 512  # bucket granularity in signatures (pallas_verify.BLOCK)
BUCKETS = (128, 1024, 10240)  # backend.BUCKETS; the last is the chunk size

COORD_ROWS = 2 * 4 * 32  # A then R, 32-row slots
TBL_ROWS = 16 * 4 * 32
DIG_ROWS = 128


def bucket_for(n: int) -> int:
    """Signatures a batch of n pads to (backend._pallas_bucket)."""
    b = BLOCK
    return max(b, min(((n + b - 1) // b) * b, BUCKETS[-1]))


_rows = point.slot_rows


# -- plain versions -----------------------------------------------------------


def k1_plain(a_t, r_t, s_t, k_t, decode):
    """(32, n) uint8 A, R, s, k bytes -> coords (COORD_ROWS, n) [A, R],
    ok (2, n), sdig (128, n), kdig (128, n) int32; digits in the
    shift-grouped order. decode((20, 2n) limbs of the low 255 bits,
    (1, 2n) sign bits) -> (ok (1, 2n) bool, point) runs once over A and R
    folded along the signature axis: ZIP-215 decompression here, the
    ristretto decode on the sr25519 path."""
    n = a_t.shape[-1]
    kw = dict(dtype=torch.int32, device=a_t.device)
    sdig = point.unpack_digits2_grouped(s_t.to(torch.int32))
    kdig = point.unpack_digits2_grouped(k_t.to(torch.int32))
    a_y, a_sign = point.unpack_limbs(a_t.to(torch.int32))
    r_y, r_sign = point.unpack_limbs(r_t.to(torch.int32))
    ok_ar, pts = decode(torch.cat([a_y, r_y], dim=1), torch.cat([a_sign, r_sign], dim=1))
    coords = torch.zeros((COORD_ROWS, n), **kw)
    ok = torch.zeros((2, n), **kw)
    for p in range(2):
        ok[p : p + 1] = ok_ar[:, p * n : (p + 1) * n].to(torch.int32)
        for c in range(4):
            coords[_rows(p, c)] = pts[c][:, p * n : (p + 1) * n]
    return coords, ok, sdig, kdig


def k1_decompress_plain(a_t, r_t, s_t, k_t):
    """(32, n) uint8 A, R, s, k bytes -> k1_plain's outputs, A and R by
    ZIP-215 decompression."""
    return k1_plain(a_t, r_t, s_t, k_t, point.decompress)


def k1_decompress_cached_plain(ctbl, oktbl, idx, r_rows, s_rows, k_rows):
    """K1 for a warm epoch. ctbl (4*32, vp), oktbl (1, vp) int32: the
    epoch table; idx (n,) int32 each signature's table column; r_rows,
    s_rows, k_rows (n, 32) uint8, row-major -> k1_decompress_plain's
    outputs. A and its flag are column idx[i]; only R decompresses."""
    n = idx.shape[0]
    kw = dict(dtype=torch.int32, device=idx.device)
    cols = idx.to(torch.int64)
    sdig = point.unpack_digits2_grouped(s_rows.T.to(torch.int32))
    kdig = point.unpack_digits2_grouped(k_rows.T.to(torch.int32))
    r_y, r_sign = point.unpack_limbs(r_rows.T.to(torch.int32))
    ok_r, pts = point.decompress(r_y, r_sign)
    coords = torch.zeros((COORD_ROWS, n), **kw)
    coords[: epoch_cache.TABLE_ROWS] = ctbl[:, cols]
    for c in range(4):
        coords[_rows(1, c)] = pts[c]
    ok = torch.cat([oktbl[:, cols], ok_r.to(torch.int32)], dim=0)
    return coords, ok, sdig, kdig


def k2_table_plain(coords):
    """coords (COORD_ROWS, n) -> tbl (TBL_ROWS, n) int32: entry s2 + 4 k2
    (s2, k2 in 0..3) holds [s2]B + [k2](-A) in Niels form."""
    n = coords.shape[-1]
    neg_a = point.point_neg(tuple(coords[_rows(0, c)] for c in range(4)))
    zero = torch.zeros((NL, n), dtype=torch.int32, device=coords.device)
    one = fe.from_int(1, coords) + zero
    base = tuple(fe.from_int(_edwards.BASE[c], coords) + zero for c in range(4))
    ident = (zero, one, one, zero)
    pair = point.cat_points([base, neg_a])
    dbl = point.point_double(pair)
    tri = point.point_add(dbl, pair)
    b_row = [ident, base, point.slice_point(dbl, 0, n), point.slice_point(tri, 0, n)]
    a_col = [ident, neg_a, point.slice_point(dbl, 1, n), point.slice_point(tri, 1, n)]
    cross = point.point_add(
        point.cat_points([b_row[s2] for k2 in (1, 2, 3) for s2 in (1, 2, 3)]),
        point.cat_points([a_col[k2] for k2 in (1, 2, 3) for s2 in (1, 2, 3)]),
    )
    entries = []
    for k2 in range(4):
        for s2 in range(4):
            if k2 == 0:
                entries.append(b_row[s2])
            elif s2 == 0:
                entries.append(a_col[k2])
            else:
                entries.append(point.slice_point(cross, (k2 - 1) * 3 + (s2 - 1), n))
    niels = point.to_niels(point.cat_points(entries))
    tbl = torch.zeros((TBL_ROWS, n), dtype=torch.int32, device=coords.device)
    for e in range(16):
        ent = point.slice_point(niels, e, n)
        for c in range(4):
            tbl[_rows(e, c)] = ent[c]
    return tbl


def ladder_plain(tbl, sdig, kdig):
    """The joint ladder [s]B + [k](-A) over K2's table: 127 iterations,
    digit positions 126 down to 0, of two doubles and a Niels add of
    entry s2 + 4 k2. Returns the extended accumulator; its T is not
    produced (the consumers never read it)."""
    n = sdig.shape[-1]
    dev = sdig.device
    zero = torch.zeros((NL, n), dtype=torch.int32, device=dev)
    one = fe.from_int(1, sdig) + zero
    acc = (zero, one, one, zero)
    limb = torch.arange(NL, device=dev)[:, None]
    for i in range(127):
        j = point.digit_row(126 - i)
        # the inner double and the add skip T; the outer double's T feeds
        # the add's t1 * T2d term
        acc = point.point_double(point.point_double(acc, need_t=False))
        e = sdig[j] + 4 * kdig[j]
        # direct indexed load of entry e (per signature)
        ent = tuple(tbl.gather(0, ((e[None, :] * 4 + c) * 32) + limb) for c in range(4))
        acc = point.point_add_niels(acc, ent, need_t=False)
    return acc


def k3_ladder_plain(tbl, sdig, kdig, coords, ok, sok):
    """tbl (TBL_ROWS, n), sdig, kdig (128, n), coords (COORD_ROWS, n),
    ok (2, n), sok (1, n) -> (1, n) int32 verdicts."""
    acc = ladder_plain(tbl, sdig, kdig)
    # [8]acc == [8]R by doubles-only projective cross-multiplication
    r8 = tuple(coords[_rows(1, c)] for c in range(4))
    for _ in range(3):
        acc = point.point_double(acc, need_t=False)
        r8 = point.point_double(r8, need_t=False)
    eq_x = fe.is_zero(fe.sub(fe.mul(acc[0], r8[2]), fe.mul(r8[0], acc[2])))
    eq_y = fe.is_zero(fe.sub(fe.mul(acc[1], r8[2]), fe.mul(r8[1], acc[2])))
    valid = (ok[0:1] != 0) & (ok[1:2] != 0) & (sok[0:1] != 0) & eq_x & eq_y
    return valid.to(torch.int32)


# -- kernel wrappers ----------------------------------------------------------


def k1_decompress(a_t, r_t, s_t, k_t):
    """K1 (replaces pallas_verify._k1_decompress_kernel); see
    k1_decompress_plain."""
    dev = kernels.device_of(a_t)
    n = a_t.shape[-1]
    for name, t in (("a_t", a_t), ("r_t", r_t), ("s_t", s_t), ("k_t", k_t)):
        kernels.check_tensor(name, t, (32, n), torch.uint8, dev)
    if dev.type == "cpu":
        return k1_decompress_plain(a_t, r_t, s_t, k_t)
    coords = torch.empty((COORD_ROWS, n), dtype=torch.int32, device=dev)
    ok = torch.empty((2, n), dtype=torch.int32, device=dev)
    sdig = torch.empty((DIG_ROWS, n), dtype=torch.int32, device=dev)
    kdig = torch.empty((DIG_ROWS, n), dtype=torch.int32, device=dev)
    kernels.launch("k1_decompress", a_t, r_t, s_t, k_t, coords, ok, sdig, kdig, n)
    return coords, ok, sdig, kdig


def k1_decompress_cached(ctbl, oktbl, idx, r_rows, s_rows, k_rows):
    """K1 for a warm epoch (replaces
    pallas_verify._k1_decompress_kernel_cached); see
    k1_decompress_cached_plain."""
    dev = kernels.device_of(idx)
    n = idx.shape[0]
    vp = ctbl.shape[-1]
    kernels.check_tensor("ctbl", ctbl, (epoch_cache.TABLE_ROWS, vp), torch.int32, dev)
    kernels.check_tensor("oktbl", oktbl, (1, vp), torch.int32, dev)
    kernels.check_tensor("idx", idx, (n,), torch.int32, dev)
    for name, t in (("r_rows", r_rows), ("s_rows", s_rows), ("k_rows", k_rows)):
        kernels.check_tensor(name, t, (n, 32), torch.uint8, dev)
    if dev.type == "cpu":
        return k1_decompress_cached_plain(ctbl, oktbl, idx, r_rows, s_rows, k_rows)
    coords = torch.empty((COORD_ROWS, n), dtype=torch.int32, device=dev)
    ok = torch.empty((2, n), dtype=torch.int32, device=dev)
    sdig = torch.empty((DIG_ROWS, n), dtype=torch.int32, device=dev)
    kdig = torch.empty((DIG_ROWS, n), dtype=torch.int32, device=dev)
    kernels.launch("k1_decompress_cached", ctbl, oktbl, idx, r_rows, s_rows, k_rows,
                   coords, ok, sdig, kdig, n, vp)
    return coords, ok, sdig, kdig


def k2_table(coords):
    """K2 (replaces pallas_verify._k2_table_kernel); see k2_table_plain."""
    dev = kernels.device_of(coords)
    n = coords.shape[-1]
    kernels.check_tensor("coords", coords, (COORD_ROWS, n), torch.int32, dev)
    if dev.type == "cpu":
        return k2_table_plain(coords)
    tbl = torch.empty((TBL_ROWS, n), dtype=torch.int32, device=dev)
    kernels.launch("k2_table", coords, tbl, n)
    return tbl


def k3_ladder(tbl, sdig, kdig, coords, ok, sok):
    """K3 (replaces pallas_verify._k3_ladder_kernel); see k3_ladder_plain."""
    dev = kernels.device_of(sok)
    n = sok.shape[-1]
    kernels.check_tensor("tbl", tbl, (TBL_ROWS, n), torch.int32, dev)
    kernels.check_tensor("sdig", sdig, (DIG_ROWS, n), torch.int32, dev)
    kernels.check_tensor("kdig", kdig, (DIG_ROWS, n), torch.int32, dev)
    kernels.check_tensor("coords", coords, (COORD_ROWS, n), torch.int32, dev)
    kernels.check_tensor("ok", ok, (2, n), torch.int32, dev)
    kernels.check_tensor("sok", sok, (1, n), torch.int32, dev)
    if dev.type == "cpu":
        return k3_ladder_plain(tbl, sdig, kdig, coords, ok, sok)
    out = torch.empty((1, n), dtype=torch.int32, device=dev)
    kernels.launch("k3_ladder", tbl, sdig, kdig, coords, ok, sok, out, n)
    return out


# -- host prep and the batch path ---------------------------------------------


def prepare_compact(entries, bucket: int):
    """EntryBlock -> (a_t, r_t, s_t, k_t (32, bucket) uint8, s_ok_t
    (1, bucket) int32), batch-minor (pallas_verify.prepare_compact).
    Host work: one SHA-512 per signature for k, the s < L check, the
    transposes. Padding signatures (A = R = identity, s = k = 0) verify."""
    from .backend import _host_rows

    n = len(entries)
    if n > bucket:
        raise ValueError(f"bucket {bucket} is below the batch's {n} signatures")
    pub, r_enc, s_enc, k_enc, s_ok = _host_rows(entries, bucket)
    return (
        np.ascontiguousarray(pub.T),
        np.ascontiguousarray(r_enc.T),
        np.ascontiguousarray(s_enc.T),
        np.ascontiguousarray(k_enc.T),
        np.ascontiguousarray(s_ok.astype(np.int32)[None, :]),
    )


def prepare_compact_cached(entries, bucket: int, ep):
    """Warm-epoch prep (pallas_verify.prepare_compact_cached): the host
    stage of prepare_compact, but the keys ship as table columns
    (entries.val_idx) and the per-signature rows stay row-major. Padding
    signatures take column vp - 1 (the identity), R = the identity,
    s = k = 0 and s_ok = 1.

    Returns (idx (bucket,) int32, r_rows, s_rows, k_rows (bucket, 32)
    uint8, s_ok_t (1, bucket) int32)."""
    from .backend import _host_rows

    if len(entries) > bucket:
        raise ValueError(f"bucket {bucket} is below the batch's {len(entries)} signatures")
    idx = epoch_cache.table_columns(entries, bucket, ep)
    _pub, r_enc, s_enc, k_enc, s_ok = _host_rows(entries, bucket)
    return idx, r_enc, s_enc, k_enc, np.ascontiguousarray(s_ok.astype(np.int32)[None, :])


def check_block(n: int) -> None:
    """Refuse a batch that bucket_for would not size."""
    if n % BLOCK:
        raise ValueError(f"batch {n} is not a multiple of BLOCK={BLOCK} (size it with bucket_for)")


def verify_compact(a_t, r_t, s_t, k_t, s_ok_t) -> torch.Tensor:
    """K1-K3 over prepare_compact's arrays as tensors on one device;
    returns the (1, n) int32 verdicts there. n is a multiple of BLOCK."""
    check_block(a_t.shape[-1])
    coords, ok, sdig, kdig = k1_decompress(a_t, r_t, s_t, k_t)
    tbl = k2_table(coords)
    return k3_ladder(tbl, sdig, kdig, coords, ok, s_ok_t)


def verify_compact_cached(ctbl, oktbl, idx, r_rows, s_rows, k_rows, s_ok_t) -> torch.Tensor:
    """The warm K1, then K2 and K3, over the epoch table and
    prepare_compact_cached's arrays as tensors on one device; returns the
    (1, n) int32 verdicts there. n is a multiple of BLOCK."""
    check_block(idx.shape[0])
    coords, ok, sdig, kdig = k1_decompress_cached(ctbl, oktbl, idx, r_rows, s_rows, k_rows)
    tbl = k2_table(coords)
    return k3_ladder(tbl, sdig, kdig, coords, ok, s_ok_t)


class SigBatch:
    """One prepared per-signature batch of at most BUCKETS[-1]
    signatures: the host arrays to copy to the device (`args`, in launch
    order), its bucket, and the epoch entry of a warm set (None when
    cold)."""

    __slots__ = ("entries", "bucket", "ep", "args")

    def __init__(self, entries, bucket: int, ep, args: tuple):
        self.entries = entries
        self.bucket = bucket
        self.ep = ep
        self.args = args

    def launch(self, dev_args) -> torch.Tensor:
        return launch_batch(self, dev_args)

    def conclude(self, row: np.ndarray) -> np.ndarray:
        return conclude_batch(self, row)


def prepare_batch(entries) -> SigBatch:
    """The host stage (numpy and the host library only; touches no
    CUDA): a block of a warm epoch (ops/epoch_cache.lookup finds its
    table) gets prepare_compact_cached's arrays, any other block, or an
    evicted epoch, prepare_compact's."""
    if len(entries) > BUCKETS[-1]:
        raise ValueError(f"a per-signature batch holds at most {BUCKETS[-1]} signatures")
    ep = epoch_cache.lookup(entries)
    bucket = bucket_for(len(entries))
    with record_function("verify.prep"):
        if ep is None:
            args = prepare_compact(entries, bucket)
        else:
            args = prepare_compact_cached(entries, bucket, ep)
    return SigBatch(entries, bucket, ep, args)


def launch_batch(batch: SigBatch, dev_args) -> torch.Tensor:
    """The device stage: batch.args as tensors on one device -> the
    (1, bucket) int32 verdicts there, launched on the current stream. A
    warm batch builds its epoch's table on first use on that device."""
    if batch.ep is None:
        with record_function("verify.kernels"):
            return verify_compact(*dev_args)
    with record_function("verify.gather"):  # builds the table once
        tables = batch.ep.coords_tables(dev_args[0].device)
    with record_function("verify.kernels"):
        return verify_compact_cached(*tables, *dev_args)


def conclude_batch(batch: SigBatch, row: np.ndarray) -> np.ndarray:
    """The verdict stage: the (1, bucket) verdicts read back to the host
    -> (n,) bool, padding cut."""
    return np.asarray(row)[0, : len(batch.entries)].astype(bool)


def verify_batch_compact(entries, *, device) -> np.ndarray:
    """EntryBlock of any size -> (n,) bool ZIP-215 verdicts,
    synchronously, in chunks of at most BUCKETS[-1] signatures, K1-K3 on
    `device`: prepare_batch, the copy, launch_batch, the readback,
    conclude_batch (the stages ops/pipeline.py runs on its threads)."""
    out = []
    for i in range(0, len(entries), BUCKETS[-1]):
        batch = prepare_batch(entries[i : i + BUCKETS[-1]])
        with record_function("verify.h2d"):
            dev_args = [torch.from_numpy(a).to(device) for a in batch.args]
        res = launch_batch(batch, dev_args)
        with record_function("verify.d2h"):  # waits for the kernels
            row = res.cpu().numpy()
        out.append(conclude_batch(batch, row))
    return np.concatenate(out) if out else np.zeros((0,), dtype=bool)
