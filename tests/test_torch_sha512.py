"""The op-graph path's hash: the port's SHA-512 layout, its plain
SHA-512, its challenge reduction and the fused prep's RAM columns
(ops/sha512.py, ops/sc.py, ops/commit_prep.py with csrc/host_prep.cpp)
against the JAX package (tendermint_tpu/ops/sha512.py, sc.py,
commit_prep.py), hashlib and Python's % L.

(a) pad_messages, pad_ram_block and pad_ram_rows give arrays byte for
    byte equal to the reference's, padding rows included.
(b) The C RAM columns of commit_prep_fused equal the port's _fill_ram and
    the reference's commit_prep._fill_ram, on commits with NIL and COMMIT
    flags; a message past the layout builds none, as _fill_ram returns
    None; ram=False builds none.
(c) sha512_blocks_plain equals the reference's sha512_blocks (one jit
    compile) and hashlib at the length field's boundaries (R || A || M of
    0, 111, 112, 127, 128, 239, 240 and 256 bytes); the plain challenge
    equals int.from_bytes(digest, "little") % L; digest_to_le_bits and
    limbs_to_bits equal the reference's.
The CUDA kernel itself is held to sha512_challenge_plain by
test_torch_quad.py's stand-in and, on the card, by test_torch_cuda.py.
Tolerance: none; every byte is equal.
"""

import hashlib
import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tendermint_tpu.ops import commit_prep as jcp  # noqa: E402
from tendermint_tpu.ops import entry_block as jeb  # noqa: E402
from tendermint_tpu.ops import sc as jsc  # noqa: E402
from tendermint_tpu.ops import sha512 as jsha  # noqa: E402
from tendermint_tpu_torch.crypto._edwards import L  # noqa: E402
from tendermint_tpu_torch.ops import commit_prep, sc, sha512  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402

torch.set_num_threads(1)

# R || A || M totals at the length field's boundaries: 111 is the longest
# one-block message, 112 the shortest of two; 239 and 240 the same for
# three; 256 is RAM_MAX_LEN
TOTALS = (64, 111, 112, 127, 128, 239, 240, 256)
MSG_LENS = (0, 1, 47, 48, 111, 112, 127, 128, 175, 176, 239, 240, 256)


def _entries(seed: int, totals) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.bytes(32), rng.bytes(t - 64), rng.bytes(64)) for t in totals]


def _assert_words_equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(sha512.as_int32(words) if words.dtype == np.uint32 else words)


# -- (a) the host layout ----------------------------------------------------------


@pytest.mark.parametrize("max_len", [128, 256])
def test_pad_messages_equals_reference(max_len):
    rng = np.random.default_rng(max_len)
    msgs = [rng.bytes(n) for n in MSG_LENS if n <= max_len]
    _assert_words_equal(sha512.pad_messages(msgs, max_len), jsha.pad_messages(msgs, max_len))
    with pytest.raises(ValueError, match="too long"):
        sha512.pad_messages([bytes(max_len + 1)], max_len)


@pytest.mark.parametrize("n,bucket", [(0, 4), (8, 8), (8, 11)])
def test_pad_ram_block_equals_reference(n, bucket):
    """Columnar layout of R || A || M, padded to the bucket with the
    identity pattern; an empty block is all padding."""
    ents = _entries(n, TOTALS[:n])
    got = sha512.pad_ram_block(EntryBlock.from_entries(ents), bucket, sha512.MAX_LEN)
    want = jsha.pad_ram_block(jeb.EntryBlock.from_entries(ents), bucket, jcp.RAM_MAX_LEN)
    _assert_words_equal(got, want)
    assert got[2][n:].tolist() == [1] * (bucket - n)


# -- (b) the fused prep's RAM columns --------------------------------------------


def _cblock(n: int, seed: int):
    """A port CommitBlock of n rows with ABSENT, COMMIT and NIL flags and
    timestamps of several varint lengths, and the set's columns."""
    from tendermint_tpu_torch.ops.entry_block import CommitBlock

    rng = np.random.default_rng(seed)
    flags = rng.choice(np.array([1, 2, 3], np.uint8), n, p=[0.1, 0.6, 0.3])
    secs = rng.choice(np.array([0, 1, 1_700_000_000, 2**40], np.int64), n)
    nanos = rng.choice(np.array([0, 127, 128, 999_999_999], np.int32), n)
    cb = CommitBlock(flags, np.arange(n, dtype=np.int32),
                     rng.integers(0, 256, (n, 64), dtype=np.uint8), secs, nanos,
                     rng.integers(0, 256, (n, 20), dtype=np.uint8))
    pub = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    power = rng.integers(1, 100, n).astype(np.int64)
    return cb, pub, power


def _prep(fn, cb, pub, power, prefix_len: int, ram):
    """The port's prep takes ram (bool), the reference's ram_max_len."""
    return fn(cb, pub, power, b"\x11" * prefix_len, b"\x22" * (prefix_len - 3), b"\x33" * 40,
              0, 0, ram)


@pytest.mark.parametrize("n", [1, 37])
def test_fused_prep_ram_columns_equal_fill_ram(n):
    """commit_prep_fused's RAM columns (C) equal the port's _fill_ram over
    the same composed sign bytes and the reference's _fill_ram over the
    reference's composition; pad_ram_rows over them equals the
    reference's pad_ram_rows and pad_ram_block."""
    cb, pub, power = _cblock(n, n)
    _, _, c = _prep(commit_prep.prep_commit, cb, pub, power, 60, True)
    _, _, p = _prep(commit_prep._prep_commit_numpy, cb, pub, power, 60, True)
    assert bytes(c.msgs) == bytes(p.msgs)
    jcb = jeb.CommitBlock(*(getattr(cb, k) for k in ("flags", "val_idx", "sig", "ts_seconds",
                                                      "ts_nanos", "addr")))
    _, _, j = _prep(jcp._prep_commit_numpy, jcb, pub, power, 60, jcp.RAM_MAX_LEN)
    assert bytes(j.msgs) == bytes(c.msgs)
    assert c.ram_hi.shape == (len(c), 48)
    if n > 1:
        assert {2, 3} <= set(cb.flags.tolist())
    for name in ("ram_hi", "ram_lo", "ram_counts"):
        np.testing.assert_array_equal(getattr(c, name), getattr(p, name))
        np.testing.assert_array_equal(getattr(c, name), np.asarray(getattr(j, name)))
        assert getattr(c, name).dtype == np.asarray(getattr(j, name)).dtype.newbyteorder("=")
    bucket = len(c) + 3
    want = jsha.pad_ram_rows(j, bucket, jcp.RAM_MAX_LEN)
    _assert_words_equal(sha512.pad_ram_rows(c, bucket, sha512.MAX_LEN), want)
    _assert_words_equal(sha512.pad_ram_block(c, bucket, sha512.MAX_LEN), want)


def test_fused_prep_builds_no_ram_past_the_layout_or_when_not_asked():
    """A sign-bytes template that makes R || A || M longer than
    RAM_MAX_LEN: no RAM columns (the reference's _fill_ram returns None,
    and its native call builds none); ram=False builds none."""
    cb, pub, power = _cblock(9, 3)
    for fn in (commit_prep.prep_commit, commit_prep._prep_commit_numpy):
        assert _prep(fn, cb, pub, power, 60, False)[2].ram_hi is None
        long = _prep(fn, cb, pub, power, 200, True)[2]
        assert long.ram_hi is None and max(np.diff(long.offsets)) > 192
    jcb = jeb.CommitBlock(cb.flags, cb.val_idx, cb.sig, cb.ts_seconds, cb.ts_nanos, cb.addr)
    assert _prep(jcp._prep_commit_numpy, jcb, pub, power, 200, jcp.RAM_MAX_LEN)[2].ram_hi is None


def test_ram_columns_ride_slices_and_concat():
    cb, pub, power = _cblock(20, 5)
    _, _, c = _prep(commit_prep.prep_commit, cb, pub, power, 60, True)
    half = len(c) // 2
    a, b = c[:half], c[half:]
    np.testing.assert_array_equal(a.ram_hi, c.ram_hi[:half])
    joined = EntryBlock.concat([a, b])
    for name in ("ram_hi", "ram_lo", "ram_counts"):
        np.testing.assert_array_equal(getattr(joined, name), getattr(c, name))
    plain = EntryBlock(b.pub, b.sig, bytes(b.msgs_contiguous()[0]), b.msgs_contiguous()[1])
    assert EntryBlock.concat([a, plain]).ram_hi is None


# -- (c) the hash and the reduction ----------------------------------------------


@pytest.fixture(scope="module")
def boundary():
    """R || A || M at the boundary totals, and the empty message, padded
    (with 2 padding rows) the reference's way."""
    ents = _entries(7, TOTALS)
    msgs = [b""] + [s[:32] + p + m for p, m, s in ents] + [sha512._PAD_PAIR] * 2
    words = sha512.pad_messages(msgs, sha512.MAX_LEN)
    return msgs, words


def test_sha512_blocks_plain_equals_reference_and_hashlib(boundary):
    import jax

    msgs, words = boundary
    got = sha512.sha512_blocks_plain(*(_t(w) for w in words))
    want = np.asarray(jax.jit(jsha.sha512_blocks)(*words))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    digests = sha512.digest_to_bytes(got.numpy())
    np.testing.assert_array_equal(digests, jsha.digest_to_bytes(want))
    assert [d.tobytes() for d in digests] == [hashlib.sha512(m).digest() for m in msgs]
    assert sorted(set(words[2].tolist())) == [1, 2, 3]


def test_challenge_plain_equals_python_mod_l(boundary):
    msgs, words = boundary
    k = sha512.sha512_challenge(*(_t(w) for w in words))
    assert k.dtype == torch.uint8 and k.shape == (len(msgs), 32)
    assert [bytes(r) for r in k.numpy()] == [
        (int.from_bytes(hashlib.sha512(m).digest(), "little") % L).to_bytes(32, "little")
        for m in msgs]


def test_scalar_bits_equal_reference(boundary):
    """digest_to_le_bits and limbs_to_bits against the reference's; the
    Horner reduction against Python's % L on digests and on the ends of
    the range (0, L - 1, L, 2^512 - 1)."""
    _, words = boundary
    digest = sha512.sha512_blocks_plain(*(_t(w) for w in words))
    bits = sc.digest_to_le_bits(digest)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jsc.digest_to_le_bits(digest.numpy().astype(np.uint32))))
    ints = [0, L - 1, L, 2**512 - 1] + [
        int.from_bytes(d.tobytes(), "little") for d in sha512.digest_to_bytes(digest.numpy())]
    ends = torch.tensor([[(v >> i) & 1 for v in ints] for i in range(512)], dtype=torch.int32)
    limbs = sc.mod_l_from_bits(ends)
    assert [sum(int(x) << (13 * i) for i, x in enumerate(col)) for col in limbs.T.tolist()] == [
        v % L for v in ints]
    np.testing.assert_array_equal(
        sc.limbs_to_bits(limbs, 253).numpy(),
        np.asarray(jsc.limbs_to_bits(limbs.T.numpy(), 253)))


def test_bound_fold_reduction_is_exact(boundary):
    """chip_smoke.sha_fold_mod_l, the reduction sha512_challenge's bound
    counts, equals Python's % L on the ends of the range and on the
    boundary digests, at a fixed 60 32 x 32 -> 64 products and 93 other
    operations, each fold's high part within its words."""
    import chip_smoke

    _, words = boundary
    digest = sha512.sha512_blocks_plain(*(_t(w) for w in words))
    ints = [0, L - 1, L, 2**252, 2**256 - 1, 2**512 - 1] + [
        int.from_bytes(d.tobytes(), "little") for d in sha512.digest_to_bytes(digest.numpy())]
    rng = np.random.default_rng(3)
    ints += [int.from_bytes(rng.bytes(64), "little") for _ in range(32)]
    for v in ints:
        assert chip_smoke.sha_fold_mod_l(v) == (v % L, 60, 93)
    assert chip_smoke.SHA_OPS_PER_BLOCK == 3_536 < chip_smoke.SHA_KERNEL_OPS_PER_BLOCK == 5_728
