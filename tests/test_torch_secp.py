"""The port's secp256k1 lane (tendermint_tpu_torch/crypto/secp256k1.py,
_weierstrass.py, ops/sc_secp.py, ops/fe_secp.py,
ops/secp_verify.py with csrc/secp256k1.cu, and the secp256k1 branches of
ops/entry_block.py, ops/epoch_cache.py, ops/backend.py, ops/pipeline.py,
ops/mixed.py and types/validation.py) on the CPU, against the JAX
package's (crypto/secp256k1.py, _weierstrass.py, ops/sc_secp.py,
ops/fe_secp.py, ops/secp_verify.py, types/validation.py).

- Keys: signatures byte-equal to the JAX package's on the same key and
  message (RFC 6979, lower-S), addresses, proto bytes, the hash of a
  secp256k1 validator set carried over as protobuf.
- Scalars and field: the GLV split, the batched inversion and the
  packing hold the JAX package's integers on random and edge scalars;
  the plain field (16-bit limbs) equals the JAX fe_secp (13-bit limbs)
  on canonical values, the ends of the range among them.
- Kernel inputs: prepare_rows, prepare_rows_cached and table_columns
  hold the JAX arrays' integers (32-bit words against 13-bit limbs).
- The ladder: the plain version against the JAX verify_kernel, jitted
  once for this file at 16 rows (chip_smoke.py's edge battery, two
  crafted rows whose point has x >= n, one padding row); the final
  coordinates against _weierstrass's u1 G + u2 Q; the cached plain
  version against the uncached one and the oracle.
- The kernel itself: csrc/secp256k1.cu compiled for the host with the
  system C++ compiler against a stand-in of the CUDA runtime (a thread
  a signature needs no shuffles: each block's threads run one after
  another), both entries against the plain versions on the 16 rows,
  verdicts and every word of the final coordinates, and its
  multiply-adds a signature equal to the count of chip_smoke.py's
  bound.
- The slice: a 12-validator secp256k1 commit through
  prepare_commit_light and the dispatcher, cold and warm, equal to the
  JAX package's prepare_commit_light and backend.verify_batch (cold,
  its epoch cache off, so its kernel reuses the one compile), lane
  verdicts compared; the synchronous verify_commit on the host;
  verify_mixed with a bad row in each lane against the JAX package's
  host verdicts on the same triples; the
  coalescer's scheme gate; the prepare seam's gate for secp256k1 sets.

Tolerance: none; every compared value is an integer or a flag.
"""

import ctypes
import dataclasses
import hashlib
import os
import random
import shutil
import subprocess
import threading

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tendermint_tpu.crypto import _weierstrass as jw  # noqa: E402
from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.crypto import encoding as jencoding  # noqa: E402
from tendermint_tpu.crypto import secp256k1 as jsecp  # noqa: E402
from tendermint_tpu.crypto import sr25519 as jsr  # noqa: E402
from tendermint_tpu.ops import backend as jbackend  # noqa: E402
from tendermint_tpu.ops import epoch_cache as jepoch  # noqa: E402
from tendermint_tpu.ops import fe_secp as jfe  # noqa: E402
from tendermint_tpu.ops import sc_secp as jsc  # noqa: E402
from tendermint_tpu.ops import secp_verify as jsv  # noqa: E402
from tendermint_tpu.types import validation as jvalidation  # noqa: E402
from tendermint_tpu.types.block import (  # noqa: E402
    BLOCK_ID_FLAG_COMMIT,
    BlockID as JBlockID,
    Commit as JCommit,
    CommitSig as JCommitSig,
    PartSetHeader as JPartSetHeader,
)
from tendermint_tpu.types.validator_set import (  # noqa: E402
    Validator as JValidator,
    ValidatorSet as JValidatorSet,
)
from tendermint_tpu.wire.canonical import Timestamp as JTimestamp  # noqa: E402
from tendermint_tpu_torch import convert  # noqa: E402
from tendermint_tpu_torch.crypto import _weierstrass as pw  # noqa: E402
from tendermint_tpu_torch.crypto import batch, encoding, secp256k1  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ped  # noqa: E402
from tendermint_tpu_torch.crypto import sr25519 as psr  # noqa: E402
from tendermint_tpu_torch.ops import backend, epoch_cache, kernels, mixed  # noqa: E402
from tendermint_tpu_torch.ops import fe_secp as fe  # noqa: E402
from tendermint_tpu_torch.ops import pipeline as pl  # noqa: E402
from tendermint_tpu_torch.ops import sc_secp as sc  # noqa: E402
from tendermint_tpu_torch.ops import secp_verify as sv  # noqa: E402
from tendermint_tpu_torch.ops import verify as pverify  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402
from tendermint_tpu_torch.types import validation  # noqa: E402
from tendermint_tpu_torch.types.block import BlockID  # noqa: E402
from tests.test_torch_pipeline import Tagged, WAIT, _until  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

N = secp256k1.N
P = fe.P
CHAIN_ID = "torch-secp-chain"
HEIGHT = 9
ROWS = 16  # the kernel tests' batch: 13 battery rows, 2 crafted, 1 padding


@pytest.fixture(autouse=True)
def _fresh():
    pl.reset_shared()
    epoch_cache.reset()
    yield
    pl.reset_shared()
    epoch_cache.reset()


def _int(words) -> int:
    return int.from_bytes(np.ascontiguousarray(words, dtype="<i4").tobytes(), "little")


def _jint(limbs, radix: int = 13) -> int:
    return sum(int(v) << (radix * i) for i, v in enumerate(np.asarray(limbs).tolist()))


# -- keys -------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_keys_sign_and_address_like_the_jax_package(seed):
    rng = random.Random(seed)
    for _ in range(2):
        d = rng.randbytes(32)
        sk, jsk = secp256k1.PrivKey(d), jsecp.PrivKey(d)
        msg = rng.randbytes(rng.randrange(1, 200))
        sig = sk.sign(msg)
        assert sig == jsk.sign(msg)
        assert int.from_bytes(sig[32:], "big") <= N // 2
        pk = sk.pub_key()
        assert pk.bytes() == jsk.pub_key().bytes() and pk.address() == jsk.pub_key().address()
        assert hashlib.new("ripemd160", hashlib.sha256(pk.bytes()).digest()).digest() == pk.address()
        assert pk.verify_signature(msg, sig) and jsk.pub_key().verify_signature(msg, sig)
        assert encoding.pubkey_to_proto(pk) == jencoding.pubkey_to_proto(jsk.pub_key())
        assert encoding.pubkey_from_proto(jencoding.pubkey_to_proto(jsk.pub_key())) == pk
    with pytest.raises(ValueError, match="invalid secp256k1 scalar"):
        secp256k1.PrivKey(N.to_bytes(32, "big"))


def test_edge_battery_verdicts_equal_the_jax_keys():
    edge = chip_smoke.secp_edge_entries()
    got = [secp256k1.PubKey(p).verify_signature(m, s) if len(p) == 33 else False
           for p, m, s in edge]
    want = [jsecp.PubKey(p).verify_signature(m, s) for p, m, s in edge]
    assert got == want == [True] * 4 + [False] * 9


def test_weierstrass_oracle_equals_jax():
    rng = random.Random(3)
    for k in [1, 2, N - 1, rng.randrange(N), rng.randrange(N)]:
        pt = pw.scalar_mult(k, pw.G)
        assert pt == jw.scalar_mult(k, jw.G)
        enc = pw.compress(pt)
        assert enc == jw.compress(pt) and pw.decompress(enc) == jw.decompress(enc) == pt
    for x in (0, 5, P - 1, P):
        for pre in (2, 3, 4):
            enc = bytes([pre]) + (x % 2**256).to_bytes(32, "big")
            assert pw.decompress(enc) == jw.decompress(enc)


def _jax_set(n: int, seed: int, key=jsecp.PrivKey):
    """(JValidatorSet, JBlockID, signed JCommit) of n secp256k1 validators
    (or of key's type); validator 0 has power 11 and the rest 10."""
    rng = np.random.default_rng(seed)
    sks = [key(rng.bytes(32)) for _ in range(n)]
    vset = JValidatorSet.new([JValidator.new(sk.pub_key(), 11 if i == 0 else 10)
                              for i, sk in enumerate(sks)])
    by_addr = {sk.pub_key().address(): sk for sk in sks}
    h = hashlib.sha256(b"secp block %d" % seed).digest()
    bid = JBlockID(hash=h, part_set_header=JPartSetHeader(total=2, hash=h[::-1]))
    sigs = [JCommitSig(BLOCK_ID_FLAG_COMMIT, v.address, JTimestamp(1_700_000_000 + i, i), b"")
            for i, v in enumerate(vset.validators)]
    commit = JCommit(height=HEIGHT, round=0, block_id=bid, signatures=sigs)
    commit.signatures = [
        dataclasses.replace(cs, signature=by_addr[vset.validators[i].address].sign(
            commit.vote_sign_bytes(CHAIN_ID, i)))
        for i, cs in enumerate(sigs)
    ]
    return vset, bid, commit


@pytest.fixture(scope="module")
def jset():
    return _jax_set(12, 41)


def test_validator_set_crosses_as_protobuf_with_the_same_hash(jset):
    vset, _, commit = jset
    pvals, pcommit = convert.state_from_wire(vset.encode(), commit.encode())
    assert pvals.hash() == vset.hash() and pvals.encode() == vset.encode()
    assert [v.address for v in pvals.validators] == [v.address for v in vset.validators]
    cols = pvals.secp256k1_columns()
    assert cols[0].shape == (12, 33) and pvals.ed25519_columns() is None
    assert cols[0].tobytes() == b"".join(v.pub_key.bytes() for v in vset.validators)
    assert batch.create_batch_verifier(pvals.validators[0].pub_key, device="cpu") is None
    assert not batch.supports_batch_verifier(pvals.validators[0].pub_key)


# -- scalars and field ------------------------------------------------------------

EDGE_SCALARS = [0, 1, 2, N - 1, N - 2, N // 2, N // 2 + 1, sc.LAMBDA, 2**128, 2**129 - 1,
                2**255, N - sc.LAMBDA]


def test_glv_inversions_and_packing_equal_jax():
    rng = random.Random(5)
    vals = EDGE_SCALARS + [rng.randrange(N) for _ in range(200)]
    for u in vals:
        assert sc.glv_split(u) == jsc.glv_split(u)
        assert sc.glv_decompose(u) == jsc.glv_decompose(u)
        k1, k2 = sc.glv_split(u)
        assert (k1 + k2 * sc.LAMBDA - u) % N == 0
    assert sc.inv_mod_n_many(vals) == jsc.inv_mod_n_many(vals)
    mags = [m for u in vals for m in sc.glv_decompose(u)[::2]]
    words, limbs = sc.scalars_to_limbs(mags), jsc.scalars_to_limbs(mags)
    assert [_int(w) for w in words] == [_jint(x) for x in limbs] == mags
    assert (sc.LAMBDA, sc.BETA, sc.A1, sc.B1, sc.A2, sc.B2) == (
        jsc.LAMBDA, jsc.BETA, jsc.A1, jsc.B1, jsc.A2, jsc.B2)


FIELD_EDGE = [0, 1, 2, 977, 2**32 + 977, P - 1, P, P + 1, 2**255, 2**256 - 1]


@pytest.mark.parametrize("op", ["mul", "add", "sub", "mul_small", "neg"])
def test_plain_field_equals_jax_fe_secp(op):
    rng = random.Random(7)
    a = FIELD_EDGE + [rng.randrange(P) for _ in range(22)]
    b = FIELD_EDGE[::-1] + [rng.randrange(P) for _ in range(22)]
    ja = np.stack([jfe.limbs_raw(v % 2**260) for v in a])
    jb = np.stack([jfe.limbs_raw(v % 2**260) for v in b])
    ta, tb = fe.from_ints(a), fe.from_ints(b)
    if op == "mul_small":
        got, want = fe.mul_small(ta, 21), jfe.mul_small(ja, 21)
    elif op == "neg":
        got, want = fe.neg(ta), jfe.neg(ja)
    else:
        got, want = getattr(fe, op)(ta, tb), getattr(jfe, op)(ja, jb)
    got_ints = fe.to_ints(fe.canon(got))
    want_ints = [_jint(x) for x in np.asarray(jfe.canon(want))]
    assert got_ints == want_ints
    assert all(0 <= v < P for v in got_ints)
    # reduced form: every limb within [-1000, 2^16 + 1000]
    assert int(got.min()) >= -1000 and int(got.max()) <= 2**16 + 1000
    words = fe.to_words(fe.canon(got))
    assert [_int(w) for w in words.numpy()] == got_ints
    assert torch.equal(fe.from_words(words), fe.canon(got))


# -- kernel inputs ------------------------------------------------------------------


def _battery():
    return chip_smoke.secp_edge_entries()


@pytest.fixture(scope="module")
def rows():
    """The 16-row kernel input: chip_smoke's battery (13 rows), the two
    crafted rows whose point has x >= n, a padding row; the port's
    arrays and the JAX package's."""
    items = _battery()
    port = list(sv.prepare_rows(items, ROWS))
    jax_args = list(jsv.prepare_rows(items, ROWS))
    wrap = chip_smoke.secp_wrap_rows()
    at = slice(len(items), len(items) + 2)
    for a, w in zip(port, wrap):
        a[at] = w
    # the same rows in the JAX package's 13-bit limbs
    ints = {k: [_int(x) for x in wrap[i]] for i, k in ((0, "qx"), (1, "qy"), (4, "r1"),
                                                      (5, "r2"))}
    for j, k in ((0, "qx"), (1, "qy"), (4, "r1"), (5, "r2")):
        jax_args[j][at] = jsv.field_to_limbs(ints[k])
    jax_args[2][at] = jsc.scalars_to_limbs([0, 0, 1, 0] * 2).reshape(2, 4, -1)
    jax_args[3][at] = 0
    jax_args[6][at] = True
    return items, port, jax_args


def test_prepare_rows_holds_the_jax_integers(rows):
    items, port, jax_args = rows
    qx, qy, scal, signs, r1, r2, ok = port
    jqx, jqy, jscal, jsigns, jr1, jr2, jok = jax_args
    for mine, theirs in ((qx, jqx), (qy, jqy), (r1, jr1), (r2, jr2)):
        assert [_int(w) for w in mine] == [_jint(x) for x in theirs]
    assert [[_int(w) for w in r] for r in scal] == [[_jint(x) for x in r] for r in jscal]
    np.testing.assert_array_equal(signs, jsigns)
    np.testing.assert_array_equal(ok, jok)
    assert ok.tolist() == [True] * 5 + [True] + [False] * 7 + [True] * 3
    assert ok[4] and ok[5]  # a tampered s and a wrong message pass the host


def test_prepare_rows_cached_and_table_columns_hold_the_jax_integers():
    items = [e for e in _battery() if len(e[0]) == 33]
    pubs = [p for p, _, _ in items][::-1]
    got, want = sv.table_columns(pubs), jsv.table_columns(pubs)
    for g, w in zip(got[:2], want[:2]):
        assert [_int(r) for r in g] == [_jint(r) for r in w]
    np.testing.assert_array_equal(got[2], want[2])
    vidx = np.array([len(pubs) - 1 - i for i in range(len(items))], dtype=np.int32)
    pad = len(pubs)
    mine = sv.prepare_rows_cached(items, vidx, ROWS, pad, len(pubs))
    theirs = jsv.prepare_rows_cached(items, vidx, ROWS, pad)
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert [[_int(w) for w in r] for r in mine[1]] == [[_jint(x) for x in r] for r in theirs[1]]
    for j in (2, 5):
        np.testing.assert_array_equal(mine[j], theirs[j])
    for j in (3, 4):
        assert [_int(w) for w in mine[j]] == [_jint(x) for x in theirs[j]]
    with pytest.raises(ValueError, match="val_idx outside"):
        sv.prepare_rows_cached(items, vidx + 1, ROWS, pad, len(pubs))


# -- the ladder -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_verdicts(rows):
    """The JAX verify_kernel on the 16 rows: its one compile in this file."""
    _, _, jax_args = rows
    return np.asarray(jsv.jitted_secp_verify()(*jax_args))


@pytest.fixture(scope="module")
def plain(rows):
    _, port, _ = rows
    out, xyz = sv.secp_verify(*[torch.from_numpy(a) for a in port], want_xyz=True)
    return out.numpy(), xyz.numpy()


def _oracle(items) -> list:
    return [secp256k1.PubKey(p).verify_signature(m, s) if len(p) == 33 else False
            for p, m, s in items]


def test_plain_ladder_equals_the_jax_kernel_and_the_oracle(rows, jax_verdicts, plain):
    items, _, _ = rows
    got, _ = plain
    assert got.tolist() == jax_verdicts.tolist()
    # the battery, the crafted rows (only the r + n candidate matches),
    # the padding row
    assert got.tolist() == _oracle(items) + [True, False, True]


def test_final_coordinates_are_u1_g_plus_u2_q(rows, plain):
    items, port, _ = rows
    _, xyz = plain
    for i, (pub, msg, sig) in enumerate(items[:4]):
        r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
        e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
        w = pow(s, -1, N)
        want = pw.point_add(pw.scalar_mult(e * w % N, pw.G),
                            pw.scalar_mult(r * w % N, pw.decompress(pub)))
        x, y, z = (_int(c) for c in xyz[i])
        zi = pow(z, -1, P)
        assert (x * zi % P, y * zi % P) == want
        assert all(_int(c) < P for c in xyz[i])
    # rejected rows carry the padding numbers: their ladder ends at G
    for i in (6, 7, 11, 12, ROWS - 1):
        x, y, z = (_int(c) for c in xyz[i])
        assert (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P) == pw.G


def test_cached_plain_equals_the_uncached_and_the_oracle(rows, plain):
    items = [e for e in rows[0] if len(e[0]) == 33]
    pubs = [p for p, _, _ in items]
    order = list(range(len(pubs)))[::-1]
    tbl = sv.table_columns([pubs[j] for j in order])  # the keys out of order
    vidx = np.array([order.index(i) for i in range(len(items))], dtype=np.int32)
    vidx[3] = 99  # outside the table: rejected
    args = sv.prepare_rows_cached(items, np.where(vidx == 99, 0, vidx), ROWS, len(pubs),
                                  len(pubs))
    args = list(args)
    args[0][3] = 99
    t = [torch.from_numpy(a) for a in tbl + tuple(args)]
    got, xyz = sv.secp_verify_cached(*t, want_xyz=True)
    want = _oracle(items)
    want[3] = False
    assert got.tolist() == want + [True] * (ROWS - len(items))
    # rows the host accepts both ways end at the same point as uncached
    uncached = list(sv.prepare_rows(items, ROWS))
    u_out, u_xyz = sv.verify_plain(*[torch.from_numpy(a) for a in uncached], want_xyz=True)
    same = [i for i in range(len(items)) if uncached[6][i] and i != 3]
    assert torch.equal(xyz[same], u_xyz[same])
    assert (got == u_out)[[i for i in range(ROWS) if i != 3]].all()


# -- the kernel on the CPU stand-in --------------------------------------------------

# The CUDA runtime as far as csrc/secp256k1.cu uses it, for the host: the
# qualifiers are empty, and mad.wide.u32 (WIDE_MAD) is plain C++ and
# counted.
SHIM = r"""
#pragma once
#include <cstdint>
#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
inline thread_local uint64_t emu_wide_mads = 0;
#define WIDE_MAD(a, b, c) \
  (++emu_wide_mads, (uint64_t)(uint32_t)(a) * (uint32_t)(b) + (uint64_t)(c))
extern "C" uint64_t emu_wide_mad_count() { return emu_wide_mads; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx, blockDim;
"""

# Both kernels cut above their C interface, whose <<<>>> launches are CUDA
# syntax; a launch runs every thread of every block in turn.
HARNESS = r"""
#include "secp_body.cu"
using namespace secp;
template <class F> static void launch(int n, F body) {
  blockDim = dim3(THREADS);
  for (int b = 0; b < (n + THREADS - 1) / THREADS; ++b)
    for (int t = 0; t < THREADS; ++t) {
      blockIdx = dim3(b);
      threadIdx = dim3(t);
      body();
    }
}
extern "C" void emu_secp_verify(const int32_t* qx, const int32_t* qy, const int32_t* scalars,
                                const int32_t* signs, const int32_t* r1, const int32_t* r2,
                                const bool* ok_host, bool* out, int32_t* xyz, int n) {
  launch(n, [=] { secp_verify_kernel(qx, qy, scalars, signs, r1, r2, ok_host, out, xyz, n); });
}
extern "C" void emu_secp_verify_cached(const int32_t* qx_tbl, const int32_t* qy_tbl,
                                       const bool* q_ok_tbl, const int32_t* val_idx,
                                       const int32_t* scalars, const int32_t* signs,
                                       const int32_t* r1, const int32_t* r2, const bool* ok_host,
                                       bool* out, int32_t* xyz, int n, int v) {
  launch(n, [=] {
    secp_verify_cached_kernel(qx_tbl, qy_tbl, q_ok_tbl, val_idx, scalars, signs, r1, r2,
                              ok_host, out, xyz, n, v);
  });
}
"""


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("secp_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    body = (kernels.CSRC / "secp256k1.cu").read_text().split("// ---- C interface")[0]
    (d / "secp_body.cu").write_text(body)
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w", f"-I{d}",
                    "-o", str(d / "libsecp_emu.so"), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libsecp_emu.so"))
    lib.emu_secp_verify.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int]
    lib.emu_secp_verify_cached.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2
    lib.emu_wide_mad_count.restype = ctypes.c_uint64
    return lib


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _emu_run(lib, args, cached: bool):
    args = [np.ascontiguousarray(a) for a in args]
    n = args[3].shape[0] if cached else args[0].shape[0]
    out = np.zeros(n, dtype=bool)
    xyz = np.zeros((n, 3, sv.NW), dtype=np.int32)
    before = lib.emu_wide_mad_count()
    if cached:
        lib.emu_secp_verify_cached(*map(_ptr, args), _ptr(out), _ptr(xyz), n, args[0].shape[0])
    else:
        lib.emu_secp_verify(*map(_ptr, args), _ptr(out), _ptr(xyz), n)
    return out, xyz, lib.emu_wide_mad_count() - before


def test_kernel_equals_plain_on_the_stand_in(emu, rows, plain):
    _, port, _ = rows
    out, xyz, mads = _emu_run(emu, port, cached=False)
    want, want_xyz = plain
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(xyz, want_xyz)
    # every signature forms the same products: the bound's count
    assert mads == ROWS * chip_smoke.SECP_WIDE_PER_SIG


def test_cached_kernel_equals_plain_on_the_stand_in(emu, rows):
    items = [e for e in rows[0] if len(e[0]) == 33]
    pubs = [p for p, _, _ in items]
    tbl = sv.table_columns(pubs[::-1])
    vidx = np.array([len(pubs) - 1 - i for i in range(len(items))], dtype=np.int32)
    args = list(sv.prepare_rows_cached(items, vidx, ROWS, len(pubs), len(pubs)))
    args[0][5] = -1  # outside the table: rejected by both
    full = list(tbl) + args
    out, xyz, mads = _emu_run(emu, full, cached=True)
    want, want_xyz = sv.secp_verify_cached(*[torch.from_numpy(a) for a in full], want_xyz=True)
    np.testing.assert_array_equal(out, want.numpy())
    np.testing.assert_array_equal(xyz, want_xyz.numpy())
    assert not out[5] and mads == ROWS * chip_smoke.SECP_WIDE_PER_SIG


# -- blocks, the epoch cache, the verifiers ---------------------------------------------


def test_entry_block_carries_the_scheme_and_the_prefix():
    items = [e for e in _battery() if len(e[0]) == 33 and len(e[2]) == 64]
    blk = EntryBlock.from_entries(items, scheme="secp256k1")
    assert blk.scheme == "secp256k1" and blk.pub.shape == (len(items), 32)
    assert [blk.entry(i) for i in range(len(blk))] == items
    part = blk[2:5]
    assert part.scheme == "secp256k1" and part.pub_bytes(0) == items[2][0]
    joined = EntryBlock.concat([blk[:3], blk[3:]])
    assert list(joined.iter_entries()) == items and joined.scheme == "secp256k1"
    ed = EntryBlock.from_entries([(bytes(32), b"m", bytes(64))])
    with pytest.raises(ValueError, match="different schemes"):
        EntryBlock.concat([blk, ed])
    with pytest.raises(ValueError, match="pub33"):
        EntryBlock.from_entries([(bytes(32), b"m", bytes(64))], scheme="secp256k1")
    assert EntryBlock.concat([blk[:0]]).scheme == "secp256k1"


def test_epoch_cache_notes_a_secp_set_and_keeps_schemes_apart(jset):
    vset, _, _ = jset
    pvals, _ = convert.state_from_wire(vset.encode(), jset[2].encode())
    epoch_cache.reset(depth=8)
    assert epoch_cache.note_valset(pvals) is None  # first sight: cold
    key = epoch_cache.note_valset(pvals)
    assert key == pvals.hash()
    ep = epoch_cache.cache().get(key)
    assert ep.scheme == "secp256k1" and ep.pub_rows.shape == (ep.vp, 33) and ep.vp == 16
    g = pw.compress(pw.G)
    assert all(r.tobytes() == g for r in ep.pub_rows[12:])
    qx, qy, ok = ep.secp_tables("cpu")
    assert ep.secp_tables("cpu")[0] is qx  # built once per device
    want = sv.table_columns([r.tobytes() for r in ep.pub_rows[:15]])
    assert all(torch.equal(t, torch.from_numpy(w)) for t, w in zip((qx, qy, ok), want))
    with pytest.raises(ValueError, match="no ed25519 table"):
        ep.coords_tables("cpu")
    rows_ = np.arange(3, dtype=np.int32)
    ed_blk = EntryBlock(np.zeros((3, 32), np.uint8), np.zeros((3, 64), np.uint8), b"",
                        np.zeros(4, np.int64), val_idx=rows_, epoch_key=key)
    assert epoch_cache.lookup(ed_blk) is None  # a secp256k1 entry for an ed25519 block
    blk = EntryBlock(np.zeros((3, 32), np.uint8), np.zeros((3, 64), np.uint8), b"",
                     np.zeros(4, np.int64), val_idx=rows_, epoch_key=key, scheme="secp256k1",
                     pub_aux=np.full(3, 2, np.uint8))
    assert epoch_cache.lookup(blk) is ep


def test_secp_verifier_and_backend_verify_batch(monkeypatch):
    items = [e for e in _battery() if len(e[2]) == 64 and len(e[0]) == 33]
    want = _oracle(items)
    bv = mixed.Secp256k1DeviceBatchVerifier(device="cpu")
    assert bv.verify() == (False, [])
    with pytest.raises(TypeError, match="pubkey is not secp256k1"):
        bv.add(ped.PubKey(bytes(32)), b"m", bytes(64))
    with pytest.raises(ValueError, match="invalid signature length"):
        bv.add(secp256k1.PubKey(items[0][0]), b"m", bytes(63))
    calls = []
    real = backend.verify_batch_secp
    monkeypatch.setattr(backend, "verify_batch_secp",
                        lambda b, device: calls.append(len(b)) or real(b, device=device))
    for n in (mixed.SECP_DEVICE_THRESHOLD - 1, len(items)):
        bv = mixed.Secp256k1DeviceBatchVerifier(device="cpu")
        for pk, msg, sig in items[:n]:
            bv.add(secp256k1.PubKey(pk), msg, sig)
        assert bv.verify() == (all(want[:n]), want[:n])
    assert calls == [len(items)]
    blk = EntryBlock.from_entries(items, scheme="secp256k1")
    assert backend.verify_batch(blk, device="cpu").tolist() == want


# -- the slice --------------------------------------------------------------------------


def _port_state(jset_, commit=None):
    vset, bid, jcommit = jset_
    pvals, pcommit = convert.state_from_wire(vset.encode(), (commit or jcommit).encode())
    return pvals, BlockID.decode(bid.encode()), pcommit


def _tampered(commit, i: int):
    sigs = list(commit.signatures)
    bad = bytearray(sigs[i].signature)
    bad[63] ^= 1
    sigs[i] = dataclasses.replace(sigs[i], signature=bytes(bad))
    return JCommit(commit.height, commit.round, commit.block_id, sigs)


def _low_power(commit):
    sigs = [JCommitSig.absent() if i % 2 else cs for i, cs in enumerate(commit.signatures)]
    return JCommit(commit.height, commit.round, commit.block_id, sigs)


def _jax_light(jset_, commit):
    """The JAX package's prepare_commit_light + backend.verify_batch, cold:
    (outcome, lane verdicts)."""
    vset, bid, _ = jset_
    jepoch.reset(depth=0)
    lanes = []
    try:
        entries, conclude = jvalidation.prepare_commit_light(CHAIN_ID, vset, bid, HEIGHT,
                                                              commit)
        valid = np.asarray(jbackend.verify_batch(entries))
        lanes = valid.tolist()
        conclude(valid)
    except Exception as e:  # the outcome under test is the exception itself
        return (type(e).__name__, str(e)), lanes
    finally:
        jepoch.reset()
    return None, lanes


def _port_light(pstate):
    pvals, pbid, pcommit = pstate
    lanes = []
    try:
        entries, conclude = validation.prepare_commit_light(CHAIN_ID, pvals, pbid, HEIGHT,
                                                             pcommit)
        assert entries.scheme == "secp256k1"
        valid = pl.shared_verifier("cpu").submit(entries).result(timeout=WAIT)
        lanes = valid.tolist()
        conclude(valid)
    except Exception as e:  # the outcome under test is the exception itself
        return (type(e).__name__, str(e)), lanes
    return None, lanes


@pytest.mark.parametrize("case", ["valid", "tampered", "low_power"])
def test_commit_light_through_the_dispatcher_matches_jax(case, jset, monkeypatch):
    """Cold (the first sight of the set) and warm (the second: the cached
    kernel over the set's table), one launch each through the shared
    dispatcher, against the JAX package's cold result."""
    commit = {"valid": jset[2], "tampered": _tampered(jset[2], 5),
              "low_power": _low_power(jset[2])}[case]
    want = _jax_light(jset, commit)
    epoch_cache.reset(depth=8)
    launched = []
    for name in ("secp_verify", "secp_verify_cached"):
        real = getattr(sv, name)
        monkeypatch.setattr(sv, name, lambda *a, _n=name, _r=real, **k: launched.append(_n)
                            or _r(*a, **k))
    cold = _port_light(_port_state(jset, commit))
    warm = _port_light(_port_state(jset, commit))
    assert cold == warm == want
    expect = {"valid": None, "tampered": "wrong signature (#5): ",
              "low_power": "invalid commit -- insufficient voting power"}[case]
    assert cold[0] is None if expect is None else cold[0][1].startswith(expect)
    if case == "low_power":
        assert launched == []
    else:
        assert launched == ["secp_verify", "secp_verify_cached"]
        assert len(cold[1]) == 8  # the light stop: 11 + 7 x 10 > 2/3 of 121


def test_prepare_seam_batches_a_secp_set_and_verify_commit_stays_on_the_host(jset,
                                                                            monkeypatch):
    """The prepare seam gates on _should_batch_prepare (a secp256k1 set
    batches), and so does the trusting check's; the synchronous
    verify_commit takes the single-signature path, as the reference's."""
    pvals, pbid, pcommit = _port_state(jset)
    entries, _ = validation.prepare_commit_light(CHAIN_ID, pvals, pbid, HEIGHT, pcommit)
    assert entries is not None and entries.scheme == "secp256k1"
    assert entries.val_idx.tolist() == list(range(len(entries)))
    t_entries, _ = validation.prepare_commit_light_trusting(
        CHAIN_ID, pvals, pcommit, validation.Fraction(1, 3))
    assert t_entries is not None and t_entries.scheme == "secp256k1"
    monkeypatch.setattr(sv, "secp_verify", lambda *a, **k: pytest.fail("no kernel"))
    tampered = _tampered(jset[2], 2)
    for commit in (jset[2], tampered):
        pv, pb, pc = _port_state(jset, commit)
        want = _outcome(lambda: jvalidation.verify_commit(CHAIN_ID, jset[0], jset[1], HEIGHT,
                                                           commit))
        got = _outcome(lambda: validation.verify_commit(CHAIN_ID, pv, pb, HEIGHT, pc,
                                                        device="cpu"))
        assert got == want
    assert got[1].startswith("wrong signature (#2): ")


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under test is the exception itself
        return type(e).__name__, str(e)
    return None


def test_verify_mixed_matches_the_oracles(monkeypatch):
    """ed25519 (through the dispatcher), sr25519 and secp256k1 lanes of 8
    or more signatures each (device lanes), one bad row in each, in an
    interleaved order; and a lane below the threshold on the host. The
    verdicts are held to the JAX package's host verification of the same
    triples: its verify_mixed is not run, since its sr25519 lane runs the
    Pallas ladder, which takes minutes in interpret mode here."""
    monkeypatch.setattr(pverify, "BLOCK", 16)
    rng = random.Random(11)
    ents, want = [], []
    for i in range(8):
        msg = b"mixed %d" % i
        eds = ped.gen_priv_key(hashlib.sha256(b"ed %d" % i).digest())
        srs = psr.PrivKey(hashlib.sha256(b"sr %d" % i).digest())
        sks = secp256k1.PrivKey(hashlib.sha256(b"secp %d" % i).digest())
        for sk in (eds, srs, sks):
            sig = sk.sign(msg)
            if i == 3:
                sig = sig[:63] + bytes([sig[63] ^ 1])
            ents.append((sk.pub_key(), msg, sig))
            want.append(i != 3)
    order = list(range(len(ents)))
    rng.shuffle(order)
    ents = [ents[j] for j in order]
    want = [want[j] for j in order]
    assert want == [pk.verify_signature(m, s) for pk, m, s in ents]
    jkeys = {"ed25519": jed.PubKey, "sr25519": jsr.PubKey, "secp256k1": jsecp.PubKey}
    assert want == [jkeys[pk.type()](pk.bytes()).verify_signature(m, s) for pk, m, s in ents]
    lanes = []
    real = backend.verify_batch_secp
    monkeypatch.setattr(backend, "verify_batch_secp",
                        lambda b, device: lanes.append(len(b)) or real(b, device=device))
    assert mixed.verify_mixed(ents, device="cpu") == want
    assert lanes == [8]
    small = [e for e in ents if e[0].type() == "secp256k1"][: mixed.SECP_DEVICE_THRESHOLD - 1]
    assert mixed.verify_mixed(small, device="cpu") == [
        jsecp.PubKey(pk.bytes()).verify_signature(m, s) for pk, m, s in small]
    assert lanes == [8]


def test_verify_mixed_reraises_a_lane_failure(monkeypatch):
    sk = secp256k1.PrivKey(hashlib.sha256(b"boom").digest())
    ents = [(sk.pub_key(), b"m%d" % i, sk.sign(b"m%d" % i)) for i in range(8)]

    def boom(block, device):
        raise RuntimeError("secp lane exploded")

    monkeypatch.setattr(backend, "verify_batch_secp", boom)
    with pytest.raises(RuntimeError, match="secp lane exploded"):
        mixed.verify_mixed(ents, device="cpu")


def _secp_block(n: int, tag: int, valid=None) -> EntryBlock:
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    pub = np.zeros((n, 32), np.uint8)
    pub[:, 0] = np.where(valid, 1, 2)
    pub[:, 1] = tag
    return EntryBlock(pub, np.zeros((n, 64), np.uint8), b"", np.zeros(n + 1, np.int64),
                      scheme="secp256k1", pub_aux=np.full(n, 2, np.uint8))


def _ed_block(n: int, tag: int) -> EntryBlock:
    pub = np.zeros((n, 32), np.uint8)
    pub[:, 0] = 1
    pub[:, 1] = tag
    return EntryBlock(pub, np.zeros((n, 64), np.uint8), b"", np.zeros(n + 1, np.int64))


def test_the_coalescer_never_fuses_blocks_of_two_schemes():
    """While the device is busy an uncached ed25519 block and two uncached
    secp256k1 blocks queue (all with the epoch key None): the two
    secp256k1 blocks fuse, the ed25519 block never joins them."""
    log, gate, schemes = [], threading.Event(), []

    def prepare(entries):
        schemes.append((entries.scheme, len(entries)))
        return Tagged(entries, log, gate if int(entries.pub[0, 1]) == 0 else None)

    v = pl.AsyncBatchVerifier("cpu", prepare=prepare, depth=1)
    try:
        first = v.submit(_ed_block(4, 0))
        _until(lambda: log == [0], "the first launch")
        valid = [True, False, True]
        futs = [v.submit(_ed_block(5, 1)), v.submit(_secp_block(3, 2, valid)),
                v.submit(_secp_block(2, 3)), v.submit(_ed_block(6, 4))]
        _until(lambda: v._q.qsize() == 0, "the queued jobs taken")
        gate.set()
        assert first.result(timeout=WAIT).all()
        # a fused batch of two schemes would have failed its jobs' futures
        got = [f.result(timeout=WAIT).tolist() for f in futs]
        assert got == [[True] * 5, valid, [True] * 2, [True] * 6]
        rows_by = {"ed25519": 0, "secp256k1": 0}
        for scheme, n in schemes:
            rows_by[scheme] += n
        assert rows_by == {"ed25519": 4 + 5 + 6, "secp256k1": 5}
        with pytest.raises(ValueError, match="different schemes"):
            EntryBlock.concat([_ed_block(1, 0), _secp_block(1, 0)])
    finally:
        gate.set()
        v.close()


def test_a_secp_block_is_split_at_its_largest_bucket(monkeypatch):
    lens = []
    log = []

    def prepare(entries):
        lens.append((entries.scheme, len(entries)))
        return Tagged(entries, log)

    monkeypatch.setattr(backend, "SECP_BUCKETS", (16, 32))
    v = pl.AsyncBatchVerifier("cpu", prepare=prepare, max_batch=64)
    try:
        assert v.submit(_secp_block(70, 1)).result(timeout=WAIT).all()
        assert sorted(lens) == [("secp256k1", 6), ("secp256k1", 32), ("secp256k1", 32)]
        lens.clear()
        assert v.submit(_ed_block(70, 1)).result(timeout=WAIT).all()
        assert sorted(lens) == [("ed25519", 6), ("ed25519", 64)]
    finally:
        v.close()


def test_verify_commits_pipelined_starts_a_batch_where_the_scheme_changes(jset):
    """An ed25519 commit, then a secp256k1 commit with a bad signature:
    one batch each (a batch holds one scheme), the secp256k1 job's
    signatures gathered by the object path (commit_entries), its bad
    signature blamed by its index in the job."""
    ed = _jax_set(12, 42, key=jed.gen_priv_key)
    jobs = []
    for vset, bid, commit in (ed, (jset[0], jset[1], _tampered(jset[2], 5))):
        pvals, pbid, pcommit = _port_state((vset, bid, commit))
        jobs.append((pvals, pbid, HEIGHT, pcommit))
    batches = []
    v = pl.shared_verifier("cpu")
    real = v.submit
    v.submit = lambda block: batches.append((block.scheme, len(block))) or real(block)
    assert pl.verify_commits_pipelined(CHAIN_ID, jobs, v) == [
        None, "wrong signature (entry 5)"]
    assert batches == [("ed25519", 8), ("secp256k1", 8)]


def test_plain_ladder_forms_the_products_of_the_bound():
    """chip_smoke.secp_products counts the plain ladder's multiplies,
    squarings and small-constant multiplies on one row: the source's
    count, on which the bound and the stand-in's multiply-add count
    rest."""
    assert chip_smoke.secp_products() == chip_smoke.SECP_OPS
    assert chip_smoke.SECP_WIDE_PER_SIG == 192_936
