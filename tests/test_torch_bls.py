"""The port's BLS12-381 aggregated-commit lane (tendermint_tpu_torch/
crypto/bls12381.py, libs/bits.py, ops/fe_bls.py, ops/bls_verify.py with
csrc/bls12381.cu, and the bls12381 branches of crypto/encoding.py,
types/block.py, types/validator_set.py, types/validation.py,
ops/entry_block.py, ops/epoch_cache.py, ops/backend.py and
ops/pipeline.py) on the CPU, against the JAX package's (crypto/
bls12381.py, libs/bits.py, ops/fe_bls.py, ops/bls_verify.py,
ops/backend.py, types/validation.py).

- Field and tower: fe_bls's limbs equal the JAX fe_bls's exactly (the
  same operations); point_add equals the JAX point_add and the affine
  oracle; f12_mul and f12_mul_sparse equal the JAX ones and the oracle's
  fp12_mul mod p (the port sums the convolutions before it reduces, so
  its limbs differ, its values do not); miller equals the oracle's at the
  affine point up to a factor in Fp (cross-multiplied).
- The kernels' plain versions against ONE module-scoped run of the JAX
  prepare_commits, jitted_bls_verify and jitted_bls_finalexp over
  chip_smoke.py's (h1) battery at K = 4 on an 8-key committee (two
  launches of each). Exact: the affine apk (cross-multiplied) and
  whether it is the identity, finalexp(f_j), the fused residue, the
  codes. Up to a factor in Fp (the apk sum's order differs from the
  reference's halving tree): the projective apk and the raw f_j,
  compared cross-multiplied.
- The kernels themselves: csrc/bls12381.cu compiled for the host with the
  system C++ compiler against a stand-in of the CUDA runtime (WIDE_MAD in
  plain C++, counted): the Montgomery product and its conversions, the
  Fp12 product and square, the line, the RCB addition with the identity
  on either side, a Miller chain of three steps and of 63, and the whole
  final exponentiation kernel (rows and fused) against the plain
  versions word for word, and their multiply-adds against
  chip_smoke.bls_fp_products.
- The slice: a committee as a ValidatorSet (crossed as protobuf) and its
  aggregated commits (crossed as AggregatedCommit bytes) through
  prepare_aggregated_commit, the dispatcher and conclude,
  verify_aggregated_commit and verify_batch_bls_codes: blame strings and
  codes equal the JAX package's (its verify_aggregated_commit and
  backend.verify_batch_bls_codes), the power tally and the bitmap size
  raised before any crypto, k_hint = 1 synchronous. The wire types,
  AggBlock's concat and pad, the coalescer's committee and scheme gates,
  fault class 4 (a vacuous subgroup check).

Tolerance: none; every compared value is an integer or a flag.
"""

import ctypes
import os
import random
import shutil
import subprocess
import time

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tendermint_tpu.crypto import bls12381 as jbls  # noqa: E402
from tendermint_tpu.crypto import encoding as jencoding  # noqa: E402
from tendermint_tpu.libs.bits import BitArray as JBitArray  # noqa: E402
from tendermint_tpu.ops import backend as jbackend  # noqa: E402
from tendermint_tpu.ops import bls_verify as jbv  # noqa: E402
from tendermint_tpu.ops import epoch_cache as jepoch  # noqa: E402
from tendermint_tpu.ops import fe_bls as jfe  # noqa: E402
from tendermint_tpu.ops.entry_block import AggBlock as JAggBlock  # noqa: E402
from tendermint_tpu.types import validation as jvalidation  # noqa: E402
from tendermint_tpu.types.block import (  # noqa: E402
    AggregatedCommit as JAggregatedCommit,
    BlockID as JBlockID,
    PartSetHeader as JPartSetHeader,
)
from tendermint_tpu.types.validator_set import (  # noqa: E402
    Validator as JValidator,
    ValidatorSet as JValidatorSet,
)
from tendermint_tpu_torch import convert  # noqa: E402
from tendermint_tpu_torch.crypto import bls12381 as bls  # noqa: E402
from tendermint_tpu_torch.crypto import encoding  # noqa: E402
from tendermint_tpu_torch.libs.bits import BitArray  # noqa: E402
from tendermint_tpu_torch.ops import backend, epoch_cache, kernels  # noqa: E402
from tendermint_tpu_torch.ops import bls_verify as bv  # noqa: E402
from tendermint_tpu_torch.ops import fe_bls as fe  # noqa: E402
from tendermint_tpu_torch.ops import pipeline as pl  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import AggBlock, EntryBlock  # noqa: E402
from tendermint_tpu_torch.types import validation  # noqa: E402
from tendermint_tpu_torch.types.block import AggregatedCommit  # noqa: E402
from tendermint_tpu_torch.types.validation import PrepareUnsupported  # noqa: E402
from tendermint_tpu_torch.types.validator_set import (  # noqa: E402
    ErrNotEnoughVotingPowerSigned,
    ValidatorSet,
)

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = bls.P
CPU = torch.device("cpu")
N_KEYS = 8  # the kernel battery's committee (chip_smoke.bls_battery_committee)
K = 4  # the kernels' bucket here
MSG = b"torch-bls kernel battery"
CHAIN_ID = "torch-bls-chain"
HEIGHT = 5
BID = (b"\x31" * 32, b"\x32" * 32)


@pytest.fixture(autouse=True)
def _fresh():
    pl.reset_shared()
    epoch_cache.reset()
    yield
    pl.reset_shared()
    epoch_cache.reset()


def _ints(words) -> list:
    return fe.ints_from_words(np.asarray(words))


def _jints(limbs) -> list:
    a = np.asarray(limbs).reshape(-1, jfe.NLIMBS)
    return [jfe.int_from_limbs(r) % P for r in a]


def _same_up_to_fp(a: list, b: list) -> bool:
    """a = c b for one nonzero c in Fp (cross-multiplied)."""
    i = next((j for j, v in enumerate(b) if v), None)
    if i is None or not a[i]:
        return not any(a) and not any(b)
    return all(x * b[i] % P == y * a[i] % P for x, y in zip(a, b))


# -- the field and the tower ----------------------------------------------------------


def _rand_limbs(rng, n):
    vals = [rng.randrange(P) for _ in range(n - 3)] + [P - 1, 0, 1]
    return vals, np.stack([jfe.limbs_from_int(v) for v in vals])


@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg", "mul_small", "carry"])
def test_fe_bls_limbs_equal_the_jax_field(op):
    import jax.numpy as jnp

    rng = random.Random(7)
    av, a = _rand_limbs(rng, 8)
    bv_, b = _rand_limbs(rng, 8)
    b = b[::-1].copy()
    ja, jb = jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32))
    pa, pb = torch.from_numpy(a), torch.from_numpy(b)
    if op == "carry":  # limbs up to carry()'s documented 1.7e8
        wide = np.random.default_rng(7).integers(-170_000_000, 170_000_000, (8, 36))
        got = fe.carry(torch.from_numpy(wide)).numpy()
        want = np.asarray(jfe.carry(jnp.asarray(wide.astype(np.int32))))
        np.testing.assert_array_equal(got, want)
        assert fe.to_ints(torch.from_numpy(got)) == [fe.int_from_limbs(r) % P for r in wide]
        return
    if op == "mul_small":
        x = np.asarray(jfe.mul_small(ja, 12))
        got = fe.mul_small(pa, 12).numpy()
    elif op == "neg":
        x = np.asarray(jfe.neg(ja))
        got = fe.neg(pa).numpy()
    else:
        x = np.asarray(getattr(jfe, op)(ja, jb))
        got = getattr(fe, op)(pa, pb).numpy()
    np.testing.assert_array_equal(got, x)
    ref = {"mul": lambda u, v: u * v, "add": lambda u, v: u + v, "sub": lambda u, v: u - v,
           "neg": lambda u, v: -u, "mul_small": lambda u, v: 12 * u}[op]
    assert fe.to_ints(torch.from_numpy(got)) == [ref(u, v) % P for u, v in zip(av, bv_[::-1])]
    assert np.abs(got).max() <= 4608


def test_words_and_limbs_convert_both_ways():
    rng = random.Random(8)
    vals = [rng.randrange(P) for _ in range(20)] + [0, 1, P - 1]
    w = fe.words_from_ints(vals)
    assert fe.ints_from_words(w) == vals
    limbs = fe.from_words(torch.from_numpy(w))
    assert [fe.int_from_limbs(r) for r in limbs.numpy()] == vals
    np.testing.assert_array_equal(limbs.numpy(), fe.field_to_limbs(vals))
    np.testing.assert_array_equal(fe.to_words(limbs).numpy(), w)
    # a reduced, not canonical, representation canonicalises
    np.testing.assert_array_equal(fe.to_words(fe.add(limbs, limbs)).numpy(),
                                  fe.words_from_ints([2 * v % P for v in vals]))


def _proj(pt, z):
    return (pt[0] * z % P, pt[1] * z % P, z) if pt is not None else (0, 1, 0)


def test_point_add_equals_jax_and_the_oracle():
    import jax.numpy as jnp

    pts = [bls.g1_mul(s, bls.G1_GEN) for s in (3, 5, 3, 11)]
    ps = [_proj(pts[0], 7), _proj(None, 1), _proj(pts[2], 13), _proj(pts[3], 2)]
    qs = [_proj(pts[1], 11), _proj(pts[1], 3), _proj(pts[0], 5), _proj(None, 1)]
    want = [bls.g1_add(pts[0], pts[1]), pts[1], bls.g1_add(pts[2], pts[0]), pts[3]]
    cols = [np.stack([fe.limbs_from_int(p[c]) for p in pp]) for pp in (ps, qs) for c in range(3)]
    got = bv.point_add(tuple(torch.from_numpy(c) for c in cols[:3]),
                       tuple(torch.from_numpy(c) for c in cols[3:]))
    jgot = jbv.point_add(tuple(jnp.asarray(c.astype(np.int32)) for c in cols[:3]),
                         tuple(jnp.asarray(c.astype(np.int32)) for c in cols[3:]))
    x, y, z = (fe.to_ints(c) for c in got)
    assert [_jints(c) for c in jgot] == [x, y, z]
    for i, w in enumerate(want):
        zi = pow(z[i], P - 2, P)
        assert (x[i] * zi % P, y[i] * zi % P) == w
    # the identity plus the identity is the identity, projectively
    ident = tuple(torch.from_numpy(fe.limbs_from_int(v)[None]) for v in (0, 1, 0))
    x, y, z = (fe.to_ints(c)[0] for c in bv.point_add(ident, ident))
    assert x == 0 and z == 0 and y != 0


def _r12(rng):
    return tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6))


def _t12(e):
    return torch.from_numpy(np.stack([fe.f2_rows([c])[0] for c in e]))


def _e12(t):
    v = fe.to_ints(t)
    return tuple((v[2 * i], v[2 * i + 1]) for i in range(6))


def test_f12_products_equal_jax_and_the_oracle():
    import jax.numpy as jnp

    rng = random.Random(9)
    a, b = _r12(rng), _r12(rng)
    ta, tb = _t12(a), _t12(b)
    got = bv.f12_mul(ta, tb)
    assert _e12(got) == bls.fp12_mul(a, b)
    ja, jb = (jnp.asarray(t.numpy().astype(np.int32)) for t in (ta, tb))
    j = jbv.f12_mul(ja, jb)
    assert _jints(j) == fe.to_ints(got)
    sparse = (a[0], (0, 0), (0, 0), a[3], (0, 0), a[5])
    l3 = ta[[0, 3, 5]]
    got = bv.f12_mul_sparse(tb, l3)
    assert _e12(got) == bls.fp12_mul(b, sparse)
    j = jbv.f12_mul_sparse(jnp.asarray(tb.numpy().astype(np.int32)),
                           jnp.asarray(l3.numpy().astype(np.int32)))
    assert _jints(j) == fe.to_ints(got)
    assert _e12(bv.f12_conj(ta)) == bls.fp12_conj(a)
    # batched, with the reduced (not canonical) outputs fed back in
    x = torch.stack([ta, tb])
    y = bv.f12_mul(bv.f12_mul(x, x), x)
    assert _e12(y[1]) == bls.fp12_mul(bls.fp12_mul(b, b), b)


def test_miller_equals_the_oracle_up_to_a_factor():
    q2 = bls.g2_mul(12345, bls.G2_GEN)
    p1 = bls.g1_mul(6, bls.G1_GEN)
    coeffs = fe.from_words(torch.from_numpy(bv._coeff_rows(q2)))
    xyz = [torch.from_numpy(fe.limbs_from_int(v)) for v in _proj(p1, 12345678)]
    got = fe.to_ints(bv.miller(coeffs, *xyz))
    want = [v for c in bls.miller(bls.g2_prepare(q2), p1) for v in c]
    assert _same_up_to_fp(got, want)


# -- the battery: the plain versions against one JAX run --------------------------------


# the battery's commits that reach the pairing (valid twice, a wrong
# signature, an identity aggregate): one launch here; the commits the
# host rejects are held to the JAX package through the slice below
DEVICE_ROWS = (0, 1, 2, 7)


@pytest.fixture(scope="module")
def committee():
    pubs = chip_smoke.bls_battery_committee(N_KEYS)
    items, codes = chip_smoke.bls_battery(N_KEYS, MSG)
    return pubs, [items[i] for i in DEVICE_ROWS], [codes[i] for i in DEVICE_ROWS]


def _chunks(items):
    return [items[c : c + K] for c in range(0, len(items), K)]


@pytest.fixture(scope="module")
def jax_run(committee):
    """The JAX kernels over the battery's DEVICE_ROWS at K = 4: per chunk
    (apk_z, f, fused, res, codes, coeffs, masks)."""
    pubs, items, _ = committee
    gx, gy, _ = jbv.table_columns_g1(pubs)
    bad = [i for i, p in enumerate(pubs) if jbls.pubkey_status(p)[1] is not None]
    out = []
    for chunk in _chunks(items):
        masks, coeffs, ok, reasons = jbv.prepare_commits(chunk, K, N_KEYS + 1, bad_rows=bad)
        apk_z, f, fused = jbv.jitted_bls_verify()(gx, gy, masks, coeffs)
        res = np.asarray(jbv.jitted_bls_finalexp()(f))
        apk_nz = np.array([jfe.int_from_limbs(np.asarray(apk_z)[j]) % P != 0 for j in range(K)])
        lane_ok = ok & apk_nz
        pair_ok = np.array([jbv.residue_is_one(r) for r in res])
        codes = jbv.verdict_codes(lane_ok & pair_ok, lane_ok & ~pair_ok, apk_nz, reasons)
        out.append((np.asarray(apk_z), np.asarray(f), np.asarray(fused), res, codes, coeffs,
                    masks))
    return out


@pytest.fixture(scope="module")
def port_run(committee):
    """The port's host prep and plain versions over the same chunks: per
    chunk (args, apk, f, fused, res, ok, reasons)."""
    pubs, items, _ = committee
    tables = bv.table_columns_g1(pubs)
    bad = bv.bad_rows(np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(-1, 48))
    out = []
    for chunk in _chunks(items):
        masks, coeffs, ok, reasons = bv.prepare_commits(chunk, K, N_KEYS + 1, bad_rows=bad)
        args = [torch.from_numpy(a) for a in (tables[0], tables[1], masks, coeffs)]
        apk, f = bv.bls_miller(*args)
        fused = bv.bls_finalexp(f, fused=True)
        res = bv.bls_finalexp(f)
        out.append((args, apk.numpy(), f.numpy(), fused.numpy()[0], res.numpy(), ok, reasons))
    return out


def test_prepare_commits_holds_the_jax_integers(committee, jax_run, port_run):
    pubs, items, _ = committee
    jgx, jgy, jok = jbv.table_columns_g1(pubs)
    gx, gy = bv.table_columns_g1(pubs)
    assert _ints(gx) == _jints(jgx) and _ints(gy) == _jints(jgy)
    # the reference's ok column is the port's bad_rows, on the host
    bad = bv.bad_rows(np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(-1, 48))
    assert np.flatnonzero(~jok).tolist() == bad
    assert bv.rlc_weights(items) == jbv.rlc_weights(items)
    for j, p in zip(jax_run, port_run):
        assert _ints(p[0][3].numpy()) == _jints(j[5])  # the line coefficients
        np.testing.assert_array_equal(p[0][2].numpy(), j[6])  # the masks


def test_plain_kernels_equal_the_jax_kernels(committee, jax_run, port_run):
    """Exact: the affine apk and whether it is the identity, every
    finalexp(f_j), the fused residue, the codes. Up to a factor in Fp:
    the projective apk (only Z is the reference's output) and f_j."""
    _, _, want_codes = committee
    got_codes = []
    for (japk_z, jf, jfused, jres, jcodes, _, _), (_, apk, f, fused, res, ok, reasons) in zip(
            jax_run, port_run):
        z = _ints(apk[:, 2])
        assert [v != 0 for v in z] == [v != 0 for v in _jints(japk_z)]
        for j in range(K):
            assert _same_up_to_fp(_ints(f[j]), _jints(jf[j]))
        assert _ints(res) == _jints(jres)
        assert _ints(fused) == _jints(jfused)
        codes, one = chip_smoke.bls_codes(apk, res, fused, ok, reasons)
        assert codes.tolist() == jcodes.tolist()
        assert one == bool((codes == bv.CODE_VALID).all())
        got_codes.extend(codes.tolist())
    assert got_codes == want_codes


def test_apk_is_the_affine_sum(committee, port_run):
    """A lane's apk is the sum of its signers' keys (a lane the host
    rejected would keep the pad commit's, g1)."""
    pubs, items, _ = committee
    for c, (_, apk, _, _, _, _, reasons) in enumerate(port_run):
        for j, (bits, _, _) in enumerate(items[c * K : c * K + K]):
            x, y, z = (_ints(apk[j, i])[0] for i in range(3))
            acc = None
            rows = np.flatnonzero(bits) if reasons[j] is None else []
            for i in rows:
                acc = bls.g1_add(acc, bls.g1_decompress(pubs[i]))
            if reasons[j] is not None:
                acc = bls.G1_GEN
            if acc is None:
                assert z == 0
            else:
                zi = pow(z, P - 2, P)
                assert (x * zi % P, y * zi % P) == acc


def test_pad_commits_verify_and_never_fail_a_batchmate(port_run):
    """A pad commit (sk = 1 on the padding row, H(PAD_MSG), z = 1) selects
    the padding row alone and takes the pad line coefficients; its
    residue is 1 (the plain versions on pad rows only)."""
    _, apk, f, fused, res, ok, reasons = port_run[0]
    assert bv.residue_is_one(res[0]) and not bv.residue_is_one(res[2])
    masks, coeffs, ok, reasons = bv.prepare_commits([], 1, N_KEYS + 1)
    assert ok.all() and reasons == [None] and masks[0].tolist() == [False] * N_KEYS + [True]
    np.testing.assert_array_equal(coeffs[0, 0], bv._coeff_rows(bls.hash_to_g2(bv.PAD_MSG)))
    apk, f = bv.verify_plain(*port_run[0][0][:2], torch.from_numpy(masks), torch.from_numpy(coeffs))
    assert _same_up_to_fp(_ints(apk[0]), [bls.GX, bls.GY, 1])
    assert bv.residue_is_one(bv.finalexp_plain(f)[0].numpy())


# -- the kernels on the CPU stand-in ------------------------------------------------------

# The CUDA runtime as far as csrc/bls12381.cu uses it, for the host: the
# qualifiers are empty or plain attributes, shared memory is static and a
# barrier does nothing (only device functions and the one-thread final
# exponentiation kernel run here), and mad.wide.u32 (WIDE_MAD) is plain
# C++ and counted.
SHIM = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static
inline void __syncthreads() {}
inline thread_local uint64_t emu_wide_mads = 0;
#define WIDE_MAD(a, b, c) \
  (++emu_wide_mads, (uint64_t)(uint32_t)(a) * (uint32_t)(b) + (uint64_t)(c))
extern "C" uint64_t emu_wide_mad_count() { return emu_wide_mads; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx, blockDim;
"""

# Entries over the kernel source cut above its C interface (whose <<<>>>
# launches are CUDA syntax); canonical words in and out.
HARNESS = r"""
#include "bls_body.cu"
using namespace bls;
static pt load_pt(const int32_t* w) {
  return pt{to_mont(fp_load(w)), to_mont(fp_load(w + NW)), to_mont(fp_load(w + 2 * NW))};
}
extern "C" void emu_fp_mul(const int32_t* a, const int32_t* b, int32_t* out, int n) {
  for (int i = 0; i < n; ++i)
    fp_store(out + i * NW, fp_mul(fp_load(a + i * NW), fp_load(b + i * NW)));
}
extern "C" void emu_to_mont(const int32_t* a, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) fp_store(out + i * NW, to_mont(fp_load(a + i * NW)));
}
extern "C" void emu_from_mont(const int32_t* a, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) fp_store(out + i * NW, from_mont(fp_load(a + i * NW)));
}
extern "C" void emu_fp12(const int32_t* a, const int32_t* b, int32_t* out, int square) {
  fp12 x, y, r;
  fp12_load_mont(x, a);
  fp12_load_mont(y, b);
  if (square) fp12_sqr(r, x); else fp12_mul(r, x, y);
  fp12_store_canon(out, r);
}
extern "C" void emu_line(const int32_t* lw, const int32_t* xyz, int32_t* out) {
  const pt p = load_pt(xyz);
  fp2 l[3];
  line_eval(l, lw, fp_mul_call(p.x, fp_const(R2_W)), p.y, fp_mul_call(p.z, fp_const(R2_W)));
  for (int s = 0; s < 3; ++s) {
    fp_store(out + (2 * s) * NW, from_mont(l[s].c0));
    fp_store(out + (2 * s + 1) * NW, from_mont(l[s].c1));
  }
}
extern "C" void emu_point_add(const int32_t* p, const int32_t* q, int32_t* out) {
  const pt r = point_add(load_pt(p), load_pt(q));
  fp_store(out, from_mont(r.x));
  fp_store(out + NW, from_mont(r.y));
  fp_store(out + 2 * NW, from_mont(r.z));
}
extern "C" void emu_miller_chain(const int32_t* co, const int32_t* xyz, int steps, int32_t* out) {
  const pt p = load_pt(xyz);
  fp12 f;
  miller_chain(f, co, p.x, p.y, p.z, steps);
  fp12_store_canon(out, f);
}
extern "C" void emu_finalexp(const int32_t* f, int32_t* out, int rows, int fused) {
  threadIdx = dim3(0);
  for (int b = 0; b < (fused ? 1 : rows); ++b) {
    blockIdx = dim3(b);
    bls_finalexp_kernel(f, out, rows, fused);
  }
}
"""


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("bls_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    body = (kernels.CSRC / "bls12381.cu").read_text().split("// ---- C interface")[0]
    (d / "bls_body.cu").write_text(body)
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w", f"-I{d}",
                    "-o", str(d / "libbls_emu.so"), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libbls_emu.so"))
    lib.emu_wide_mad_count.restype = ctypes.c_uint64
    return lib


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _mads(lib, fn, *args) -> int:
    before = lib.emu_wide_mad_count()
    fn(*args)
    return lib.emu_wide_mad_count() - before


def test_stand_in_montgomery_product_and_conversions(emu):
    rng = random.Random(10)
    a = [rng.randrange(P) for _ in range(8)] + [P - 1, P - 1, 0, 1]
    b = [rng.randrange(P) for _ in range(8)] + [P - 1, 1, P - 1, 1]
    wa, wb = fe.words_from_ints(a), fe.words_from_ints(b)
    out = np.zeros_like(wa)
    rinv = pow(1 << 384, -1, P)
    n = _mads(emu, emu.emu_fp_mul, _ptr(wa), _ptr(wb), _ptr(out), len(a))
    assert fe.ints_from_words(out) == [x * y * rinv % P for x, y in zip(a, b)]
    assert n == len(a) * chip_smoke.BLS_WIDE_PER_FP
    emu.emu_to_mont(_ptr(wa), _ptr(out), len(a))
    assert fe.ints_from_words(out) == [x * (1 << 384) % P for x in a]
    emu.emu_from_mont(_ptr(wa), _ptr(out), len(a))
    assert fe.ints_from_words(out) == [x * rinv % P for x in a]


@pytest.mark.parametrize("square", [0, 1])
def test_stand_in_fp12_product_equals_plain(emu, square):
    rng = random.Random(11 + square)
    a, b = _r12(rng), _r12(rng)
    wa, wb = fe.to_words(_t12(a)).numpy(), fe.to_words(_t12(b)).numpy()
    out = np.zeros_like(wa)
    n = _mads(emu, emu.emu_fp12, _ptr(wa), _ptr(wb), _ptr(out), square)
    want = bv.f12_mul(_t12(a), _t12(a) if square else _t12(b))
    np.testing.assert_array_equal(out, fe.to_words(want).numpy())
    # 24 conversions in, 12 out, and the product's own
    assert n == (24 + 12 + (57 if square else 108)) * chip_smoke.BLS_WIDE_PER_FP


def test_stand_in_line_and_point_add_equal_plain(emu):
    p1 = bls.g1_mul(3, bls.G1_GEN)
    p2 = bls.g1_mul(5, bls.G1_GEN)
    coeffs = bv._coeff_rows(bls.g2_mul(777, bls.G2_GEN))
    pt = fe.words_from_ints(_proj(p1, 7))
    out = np.zeros((3, 2, fe.NWORDS), dtype=np.int32)
    for step, s in ((0, 0), (0, 1), (5, 0)):  # step 0's add is skipped: (0, 0)
        lw = np.ascontiguousarray(coeffs[step, s])
        emu.emu_line(_ptr(lw), _ptr(pt), _ptr(out))
        lc = fe.from_words(torch.from_numpy(lw))
        xyz = fe.from_words(torch.from_numpy(pt))
        np.testing.assert_array_equal(out, fe.to_words(bv._line_slots(lc[0], lc[1], *xyz)).numpy())
    ident = fe.words_from_ints((0, 1, 0))
    cases = [(fe.words_from_ints(_proj(p1, 7)), fe.words_from_ints(_proj(p2, 11))),
             (ident, fe.words_from_ints(_proj(p2, 11))),
             (fe.words_from_ints(_proj(p1, 7)), ident), (ident, ident),
             (fe.words_from_ints(_proj(p1, 7)), fe.words_from_ints(_proj(p1, 3)))]
    for p, q in cases:
        got = np.zeros((3, fe.NWORDS), dtype=np.int32)
        emu.emu_point_add(_ptr(p), _ptr(q), _ptr(got))
        lp = fe.from_words(torch.from_numpy(p))
        lq = fe.from_words(torch.from_numpy(q))
        want = torch.stack([fe.to_words(c) for c in bv.point_add(tuple(lp), tuple(lq))])
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("steps", [3, 63])
def test_stand_in_miller_chain_equals_plain(emu, steps):
    coeffs = np.ascontiguousarray(bv._coeff_rows(bls.g2_mul(4242, bls.G2_GEN)))
    pt = fe.words_from_ints(_proj(bls.g1_mul(9, bls.G1_GEN), 31337))
    out = np.zeros((6, 2, fe.NWORDS), dtype=np.int32)
    n = _mads(emu, emu.emu_miller_chain, _ptr(coeffs), _ptr(pt), steps, _ptr(out))
    xyz = fe.from_words(torch.from_numpy(pt))
    if steps == bv.N_ATE:
        want = bv.miller(fe.from_words(torch.from_numpy(coeffs)), *xyz)
    else:  # the plain loop cut to `steps` steps
        cl = fe.from_words(torch.from_numpy(coeffs))
        f = bv.f12_one((), CPU)
        for s in range(steps):
            f = bv.f12_mul(f, f)
            for d in range(2):
                f = bv.f12_mul_sparse(f, bv._line_slots(cl[s, d, 0], cl[s, d, 1], *xyz))
        want = bv.f12_conj(f)
    np.testing.assert_array_equal(out, fe.to_words(want).numpy())
    # 3 conversions and 12 outputs here; the chain's X R^2, Z R^2 and steps
    assert n == (15 + 2 + steps * chip_smoke.BLS_STEP_PRODUCTS) * chip_smoke.BLS_WIDE_PER_FP


def test_stand_in_final_exponentiation_kernel_equals_plain(emu, port_run):
    """The whole bls_finalexp_kernel (one thread a row needs no barrier),
    rows and fused, over chunk 0's f_j, against the plain versions'
    residues of port_run."""
    _, _, f, fused, res, _, _ = port_run[0]
    f = np.ascontiguousarray(f)
    out = np.zeros((K, 6, 2, fe.NWORDS), dtype=np.int32)
    n = _mads(emu, emu.emu_finalexp, _ptr(f), _ptr(out), K, 0)
    np.testing.assert_array_equal(out, res)
    assert n == chip_smoke.bls_fp_products("bls_finalexp", K, 0) * chip_smoke.BLS_WIDE_PER_FP
    one = np.zeros((1, 6, 2, fe.NWORDS), dtype=np.int32)
    n = _mads(emu, emu.emu_finalexp, _ptr(f), _ptr(one), K, 1)
    np.testing.assert_array_equal(one[0], fused)
    assert n == (chip_smoke.bls_fp_products("bls_finalexp_fused", K, 0)
                 * chip_smoke.BLS_WIDE_PER_FP)


def test_miller_count_matches_the_source(committee):
    # the header's count of a commit, from the parts the stand-in counts
    assert chip_smoke.bls_fp_products("bls_miller", 1, 10) == 14 * 10 + 23_451
    assert chip_smoke.BLS_FINALEXP_PRODUCTS == 475_314


# -- keys, wire types, blocks ------------------------------------------------------------


def test_bound_counts_what_the_function_needs(port_run):
    """chip_smoke's BLS bound counts the function's products on the run's
    data (signers, the ate loop's doubling and addition lines), fewer than
    the kernels form."""
    assert chip_smoke.BLS_FINALEXP_BOUND == 7_851
    args = port_run[0][0]
    masks, coeffs = args[2].numpy(), args[3].numpy()
    lines = bv.N_ATE + sum(bls.ATE_BITS)  # a pair's: every doubling, an add a one bit
    want = sum(11 * max(int(m.sum()) - 1, 0) + 36 * (bv.N_ATE - 1) + (4 + 2) * lines
               + 39 * (2 * lines - 2) for m in masks)
    got = chip_smoke.bls_bound_products("bls_miller", masks, coeffs)
    assert got == want < chip_smoke.bls_fp_products("bls_miller", K, masks.shape[1])
    for name, n in (("bls_finalexp_fused", 54 * (K - 1) + 7_851), ("bls_finalexp", K * 7_851)):
        assert chip_smoke.bls_bound_products(name, masks, coeffs) == n
        assert n < chip_smoke.bls_fp_products(name, K, 0)


def test_keys_sign_and_encode_like_the_jax_package():
    for d in (b"\x05", b"\x2a\x01"):
        sk, jsk = bls.PrivKey(d.rjust(32, b"\x00")), jbls.PrivKey(d.rjust(32, b"\x00"))
        pk = sk.pub_key()
        assert pk.bytes() == jsk.pub_key().bytes() and pk.address() == jsk.pub_key().address()
        assert sk.sign(b"m") == jsk.sign(b"m")
        assert encoding.pubkey_to_proto(pk) == jencoding.pubkey_to_proto(jsk.pub_key())
        assert encoding.pubkey_from_proto(jencoding.pubkey_to_proto(jsk.pub_key())) == pk
    assert chip_smoke.bls_keys(5)[-1] == bls.PrivKey((5).to_bytes(32, "big")).pub_key().bytes()


def test_bit_array_and_aggregated_commit_round_trip_like_jax():
    for n, on in ((1, [0]), (70, [0, 3, 64, 69]), (128, list(range(0, 128, 3)))):
        ba, jba = BitArray(n), JBitArray(n)
        for i in on:
            ba.set_index(i, True)
            jba.set_index(i, True)
        assert ba.encode() == jba.encode() and BitArray.decode(jba.encode()) == ba
        assert ba.get_true_indices() == on and ba.size() == n
        jbid = JBlockID(hash=BID[0], part_set_header=JPartSetHeader(total=2, hash=BID[1]))
        jagg = JAggregatedCommit(height=HEIGHT, round=1, block_id=jbid, signature=b"\x07" * 96,
                                 signers=jba)
        agg = AggregatedCommit.decode(jagg.encode())
        assert agg.encode() == jagg.encode()
        assert agg.sign_bytes(CHAIN_ID) == jagg.sign_bytes(CHAIN_ID)
        agg.validate_basic()
    agg.signature = b"\x07" * 95
    with pytest.raises(ValueError, match="aggregate signature is 95 bytes, want 96"):
        agg.validate_basic()
    agg.signature, agg.signers = b"\x07" * 96, None
    with pytest.raises(ValueError, match="no signer bitmap"):
        agg.validate_basic()


def test_agg_block_concat_pad_and_slices():
    pub48 = np.frombuffer(b"".join(chip_smoke.bls_keys(3)), np.uint8).reshape(3, 48)
    rows = [(np.array([1, 0, 1], bool), b"m%d" % i, bytes([i]) * 96) for i in range(3)]
    a = AggBlock.from_commits(rows[:2], pub48, b"A")
    b = AggBlock.from_commits(rows[2:], pub48, b"A")
    j = AggBlock.concat([a, AggBlock.pad(2), b])
    assert len(j) == 5 and j.epoch_key == b"A" and j.is_pad.tolist() == [0, 0, 1, 1, 0]
    assert [j.msg(i) for i in (0, 1, 4)] == [b"m0", b"m1", b"m2"] and j.msg(2) == b""
    assert not j.bits[2:4].any() and j.bits[4].tolist() == [True, False, True]
    assert j[1:3].msg(0) == b"m1" and j[1:3].epoch_key == b"A"
    with pytest.raises(ValueError, match="mixed-committee"):
        AggBlock.concat([a, AggBlock.from_commits(rows[:1], pub48, b"B")])
    pads = AggBlock.concat([AggBlock.pad(1), AggBlock.pad(2)])
    assert pads.epoch_key is None and len(pads) == 3
    # the same rules as the JAX package's AggBlock
    ja = JAggBlock.from_commits(rows[:2], pub48, b"A")
    jj = JAggBlock.concat([ja, JAggBlock.pad(2), JAggBlock.from_commits(rows[2:], pub48, b"A")])
    np.testing.assert_array_equal(jj.bits, j.bits)
    np.testing.assert_array_equal(jj.offsets, j.offsets)
    assert bytes(jj.msgs) == bytes(j.msgs)
    with pytest.raises(ValueError, match="pad rows must be trailing"):
        bv.prepare_batch(AggBlock.concat([AggBlock.pad(1), a]))


# -- the slice --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_set():
    """A committee as the JAX package's ValidatorSet: five honest keys (sk
    1..5, power 100), the two crafted non-subgroup keys and the key that
    cancels sk 1..4 (power 1 each); crossed to the port as protobuf.
    Returns (port set, JAX set, rows by role)."""
    pubs = chip_smoke.bls_keys(5) + chip_smoke.bls_bad_g1(2) + [
        bls.g1_compress(bls.g1_neg(bls.g1_mul(10, bls.G1_GEN)))]
    jvset = JValidatorSet.new([JValidator.new(jbls.PubKey(p), 100 if i < 5 else 1)
                               for i, p in enumerate(pubs)])
    rows = {p: i for i, p in enumerate(v.pub_key.bytes() for v in jvset.validators)}
    vset = ValidatorSet.decode(jvset.encode())
    assert vset.hash() == jvset.hash() and vset.encode() == jvset.encode()
    return vset, jvset, [rows[p] for p in pubs]


def _slice_case(jvset, role_rows, roles, sig):
    """(port commit, JAX commit) signed by the roles' rows, carrying sig
    (an int scalar of H(m), or raw bytes)."""
    jbid = JBlockID(hash=BID[0], part_set_header=JPartSetHeader(total=2, hash=BID[1]))
    ba = JBitArray(jvset.size())
    for r in roles:
        ba.set_index(role_rows[r], True)
    jagg = JAggregatedCommit(height=HEIGHT, round=0, block_id=jbid, signers=ba)
    if isinstance(sig, int):
        h = jbls.hash_to_g2(jagg.sign_bytes(CHAIN_ID))
        sig = jbls.g2_compress(jbls.g2_mul(sig, h))
    jagg.signature = sig
    return convert.agg_state_from_wire(jvset.encode(), jagg.encode())[1], jagg


# (roles signing, the signature): the five honest keys are roles 0..4 (sk
# 1..5), the crafted keys 5 and 6, the canceling key 7
SLICE_CASES = {
    "valid": ((0, 1, 2, 3, 4), 15),
    "wrong": ((0, 1, 2, 3), 11),
    "apk_identity": ((0, 1, 2, 3, 7), 4),
    "bad_pub": ((0, 1, 2, 3, 5, 6), 3),
    "malformed": ((0, 1, 2, 3), b"\xff" * 96),
    "identity_sig": ((0, 1, 2, 3), bytes([0xC0]) + bytes(95)),
    "subgroup_sig": ((0, 1, 2, 3), None),
}
DEVICE_GROUP = ("valid", "wrong", "apk_identity", "bad_pub")
HOST_GROUP = ("malformed", "identity_sig", "subgroup_sig")


@pytest.fixture(scope="module")
def slice_commits(slice_set):
    _, jvset, role_rows = slice_set
    out = {}
    for name, (roles, sig) in SLICE_CASES.items():
        out[name] = _slice_case(jvset, role_rows, roles,
                                chip_smoke.bls_bad_g2() if sig is None else sig)
    return out


def _jax_walk(jvset, jagg):
    jbid = jagg.block_id
    try:
        jvalidation.verify_aggregated_commit(CHAIN_ID, jvset, jbid, HEIGHT, jagg)
        return None
    except ValueError as e:
        return str(e)


def _port_bid():
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader

    return BlockID(hash=BID[0], part_set_header=PartSetHeader(total=2, hash=BID[1]))


@pytest.fixture(scope="module")
def jax_blame(slice_set, slice_commits):
    _, jvset, _ = slice_set
    return {name: _jax_walk(jvset, jagg) for name, (_, jagg) in slice_commits.items()}


def test_the_jax_walk_blames_the_battery(slice_set, slice_commits, jax_blame):
    _, _, role_rows = slice_set
    sig = {n: c[1].signature.hex().upper() for n, c in slice_commits.items()}
    low = min(role_rows[5], role_rows[6])
    assert jax_blame == {
        "valid": None,
        "wrong": f"wrong aggregate signature: {sig['wrong']}",
        "apk_identity": "aggregate pubkey is the identity",
        "bad_pub": f"subgroup aggregate pubkey (validator #{low})",
        "malformed": f"malformed aggregate signature: {sig['malformed']}",
        "identity_sig": f"identity aggregate signature: {sig['identity_sig']}",
        "subgroup_sig": f"subgroup aggregate signature: {sig['subgroup_sig']}",
    }


def _port_walk(vset, agg):
    try:
        validation.verify_aggregated_commit(CHAIN_ID, vset, _port_bid(), HEIGHT, agg)
        return None
    except ValueError as e:
        return str(e)


def test_verify_aggregated_commit_equals_the_jax_walk(slice_set, slice_commits, jax_blame):
    vset = slice_set[0]
    assert {n: _port_walk(vset, c[0]) for n, c in slice_commits.items()} == jax_blame


def _conclude(conclude, codes):
    try:
        conclude(codes)
        return None
    except ValueError as e:
        return str(e)


def test_prepare_aggregated_commit_through_the_dispatcher(slice_set, slice_commits, jax_blame,
                                                          monkeypatch):
    """The device group's four commits fuse into one batch of the shared
    dispatcher (a K = 4 launch A, launch B for the failing lanes), warm
    (the committee's epoch entry); each conclude gives the JAX walk's
    blame (the JAX kernels' codes on such lanes: test_plain_kernels_*)."""
    vset = slice_set[0]
    widths = []
    real = bv.prepare_batch

    def spy(block, ep=None):
        widths.append((len(block), ep is not None))
        return real(block, ep)

    monkeypatch.setattr(bv, "prepare_batch", spy)
    pairs = [validation.prepare_aggregated_commit(CHAIN_ID, vset, _port_bid(), HEIGHT,
                                                  slice_commits[n][0], k_hint=4)
             for n in DEVICE_GROUP]
    v = pl.shared_verifier("cpu")
    futs = [v.submit(blk) for blk, _ in pairs]
    codes = [f.result(timeout=300) for f in futs]
    assert widths == [(4, True)]
    assert all(c.dtype == np.int32 and c.shape == (1,) for c in codes)
    got = {n: _conclude(c, r) for n, (_, c), r in zip(DEVICE_GROUP, pairs, codes)}
    assert got == {n: jax_blame[n] for n in DEVICE_GROUP}
    assert np.concatenate(codes).tolist() == [1, 2, 3, bv.CODE_PUB_BASE + min(
        slice_set[2][5], slice_set[2][6])]


def test_verify_batch_bls_codes_equals_the_jax_backend(slice_set, slice_commits, jax_blame,
                                                       monkeypatch):
    """The host group (every lane rejected before the pairing) through the
    synchronous path, cold (the epoch cache off): the codes equal the JAX
    backend's, and each decodes to the walk's blame."""
    vset, jvset, _ = slice_set
    epoch_cache.reset(0)
    pub48 = vset.bls12381_columns()[0]
    items = []
    for n in HOST_GROUP:
        agg = slice_commits[n][0]
        bits = np.zeros(vset.size(), dtype=bool)
        bits[agg.signers.get_true_indices()] = True
        items.append((bits, agg.sign_bytes(CHAIN_ID), agg.signature))
    block = AggBlock.from_commits(items, pub48, vset.hash())
    codes = backend.verify_batch_bls_codes(block, device="cpu")
    jepoch.reset(0)
    try:
        jcodes = jbackend.verify_batch_bls_codes(JAggBlock.from_commits(items, pub48, vset.hash()))
    finally:
        jepoch.reset()
    assert codes.tolist() == np.asarray(jcodes).tolist() == [4, 5, 6]
    monkeypatch.setattr(backend, "verify_batch_bls_codes", lambda b, device: codes)
    assert backend.verify_batch(block, device="cpu").tolist() == [False] * 3
    for n, code in zip(HOST_GROUP, codes):
        blk, conclude = validation.prepare_aggregated_commit(
            CHAIN_ID, vset, _port_bid(), HEIGHT, slice_commits[n][0], k_hint=2)
        assert _conclude(conclude, np.array([code], np.int32)) == jax_blame[n]


def test_power_tally_and_bitmap_size_are_checked_before_any_crypto(slice_set, monkeypatch):
    vset, jvset, role_rows = slice_set
    calls = []
    monkeypatch.setattr(bls, "signature_status", lambda s: calls.append(s))
    low, jlow = _slice_case(jvset, role_rows, (0, 1), 3)
    want = str(ErrNotEnoughVotingPowerSigned(got=200, needed=503 * 2 // 3))
    for k_hint in (1, 4):
        with pytest.raises(ErrNotEnoughVotingPowerSigned) as ei:
            validation.prepare_aggregated_commit(CHAIN_ID, vset, _port_bid(), HEIGHT, low,
                                                 k_hint=k_hint)
        assert str(ei.value) == want == _jax_walk(jvset, jlow)
    short = JBitArray(jvset.size() - 1)
    short.set_index(0, True)
    jlow.signers = short
    low.signers = BitArray.decode(short.encode())
    with pytest.raises(ValueError) as ei:
        validation.prepare_aggregated_commit(CHAIN_ID, vset, _port_bid(), HEIGHT, low, k_hint=4)
    assert str(ei.value) == _jax_walk(jvset, jlow) == (
        "invalid commit -- wrong set size: 8 vs 7")
    assert calls == []


def test_k_hint_one_verifies_synchronously(slice_set, slice_commits, jax_blame, monkeypatch):
    vset = slice_set[0]
    monkeypatch.setattr(bv, "prepare_batch", lambda *a: pytest.fail("the device lane ran"))
    assert validation.prepare_aggregated_commit(
        CHAIN_ID, vset, _port_bid(), HEIGHT, slice_commits["valid"][0]) == (None, None)
    with pytest.raises(ValueError) as ei:
        validation.prepare_aggregated_commit(CHAIN_ID, vset, _port_bid(), HEIGHT,
                                             slice_commits["wrong"][0], k_hint=1)
    assert str(ei.value) == jax_blame["wrong"]


def test_an_ed25519_set_is_not_a_bls_committee():
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    vset = ValidatorSet.new([Validator.new(ed25519.gen_priv_key(bytes([i]) * 32).pub_key(), 10)
                             for i in range(3)])
    assert vset.bls12381_columns() is None
    ba = BitArray(3)
    for i in range(3):
        ba.set_index(i, True)
    agg = AggregatedCommit(height=HEIGHT, block_id=_port_bid(), signature=b"\x00" * 96,
                           signers=ba)
    with pytest.raises(PrepareUnsupported):
        validation.prepare_aggregated_commit(CHAIN_ID, vset, _port_bid(), HEIGHT, agg, k_hint=2)


def test_epoch_cache_notes_a_bls_set_and_builds_its_table(slice_set):
    vset = slice_set[0]
    assert epoch_cache.note_valset(vset) is None  # cold: registered
    assert epoch_cache.note_valset(vset) == vset.hash()
    ep = epoch_cache.cache().get(vset.hash())
    assert ep.scheme == "bls12381" and ep.vp == 16 and ep.n_vals == 8
    assert backend.bls_epoch(AggBlock.from_commits([], vset.bls12381_columns()[0],
                                                   vset.hash())) is ep
    gx, gy = ep.bls_tables("cpu")
    want = bv.table_columns_g1([r.tobytes() for r in ep.pub_rows[: ep.vp - 1]])
    np.testing.assert_array_equal(gx.numpy(), want[0])
    np.testing.assert_array_equal(gy.numpy(), want[1])
    assert fe.ints_from_words(gx.numpy())[8:] == [bls.GX] * 8  # the padding rows
    assert ep.pub_rows[8:].tobytes() == bls.g1_compress(bls.G1_GEN) * 8
    with pytest.raises(ValueError, match="no secp256k1 table"):
        ep.secp_tables("cpu")


class _Codes:
    """A stand-in prepared batch of either scheme: its rows verify
    (codes 1, or True), and it records (scheme, epoch key, rows)."""

    def __init__(self, entries, log):
        self.entries = entries
        self.bucket = len(entries)
        self.codes = entries.scheme == "bls12381"
        self.args = (np.zeros(len(entries), dtype=np.int32),)
        log.append((entries.scheme, entries.epoch_key, len(entries)))

    def launch(self, dev_args):
        return (dev_args[0] + 1) if self.codes else (dev_args[0] == 0)

    def conclude(self, row):
        return np.asarray(row)


def test_the_coalescer_fuses_one_committee_and_nothing_else():
    log = []
    pub48 = np.frombuffer(b"".join(chip_smoke.bls_keys(2)), np.uint8).reshape(2, 48)
    row = [(np.ones(2, bool), b"m", b"\x01" * 96)]
    a1, a2 = (AggBlock.from_commits(row, pub48, b"A") for _ in range(2))
    b1 = AggBlock.from_commits(row, pub48, b"B")
    ed = EntryBlock.from_entries([(bytes(32), b"m", bytes(64))], scheme="ed25519")
    v = pl.AsyncBatchVerifier("cpu", prepare=lambda e: _Codes(e, log))
    try:
        futs = [v.submit(x) for x in (a1, a2, b1, ed)]
        got = [f.result(timeout=30) for f in futs]
    finally:
        v.close()
    assert log == [("bls12381", b"A", 2), ("bls12381", b"B", 1), ("ed25519", None, 1)]
    assert [g.dtype for g in got] == [np.int32] * 3 + [np.bool_]
    assert [g.tolist() for g in got] == [[1], [1], [1], [True]]


@pytest.mark.parametrize("linger", [0.0, 0.6])
def test_the_idle_coalescer_waits_as_backend_says(monkeypatch, linger):
    """The dispatcher names no scheme: how long an idle coalescer waits
    for a second AggBlock of one committee is backend.coalesce_linger's
    (5 ms for bls12381, none for the other schemes)."""
    assert backend.coalesce_linger("bls12381") == 0.005
    assert backend.coalesce_linger("ed25519") == backend.coalesce_linger("secp256k1") == 0.0
    monkeypatch.setattr(backend, "coalesce_linger", lambda scheme="ed25519": linger)
    log = []
    pub48 = np.frombuffer(b"".join(chip_smoke.bls_keys(2)), np.uint8).reshape(2, 48)
    row = [(np.ones(2, bool), b"m", b"\x01" * 96)]
    a1, a2 = (AggBlock.from_commits(row, pub48, b"A") for _ in range(2))
    v = pl.AsyncBatchVerifier("cpu", prepare=lambda e: _Codes(e, log))
    try:
        f1 = v.submit(a1)
        time.sleep(0.2)
        f2 = v.submit(a2)
        assert [f.result(timeout=30).tolist() for f in (f1, f2)] == [[1], [1]]
    finally:
        v.close()
    assert log == ([("bls12381", b"A", 2)] if linger else [("bls12381", b"A", 1)] * 2)


def test_fault_class_4_subgroup_checks_are_not_vacuous(slice_set, slice_commits, jax_blame):
    """A crafted on-curve point outside the prime-order subgroup: g1_mul(R,
    .) of it is not the identity (multiplying by R without reducing R
    first), so its key is blamed `subgroup` at its row, and a G2
    signature of that kind is blamed `subgroup aggregate signature`."""
    bad = chip_smoke.bls_bad_g1(1)[0]
    pt = bls.g1_decompress(bad)
    assert bls.g1_on_curve(pt) and bls.g1_mul(bls.R, pt) is not None
    assert bls.pubkey_status(bad) == (None, "subgroup")
    g2 = bls.g2_decompress(chip_smoke.bls_bad_g2())
    assert bls.g2_on_curve(g2) and bls.g2_mul(bls.R, g2) is not None
    vset, _, role_rows = slice_set
    assert _port_walk(vset, slice_commits["bad_pub"][0]) == (
        f"subgroup aggregate pubkey (validator #{min(role_rows[5], role_rows[6])})")
    assert _port_walk(vset, slice_commits["subgroup_sig"][0]).startswith(
        "subgroup aggregate signature: ")


def test_wrappers_check_their_arguments():
    gx = torch.zeros((5, fe.NWORDS), dtype=torch.int32)
    masks = torch.zeros((4, 5), dtype=torch.bool)
    coeffs = torch.zeros((4, 2, bv.N_ATE, 2, 2, 2, fe.NWORDS), dtype=torch.int32)
    with pytest.raises(ValueError, match="gy must be"):
        bv.bls_miller(gx, gx[:4], masks, coeffs)
    with pytest.raises(ValueError, match="coeffs must be"):
        bv.bls_miller(gx, gx, masks, coeffs[:, :1])
    with pytest.raises(ValueError, match="f must be"):
        bv.bls_finalexp(torch.zeros((2, 6, 2, 11), dtype=torch.int32))
    with pytest.raises(ValueError, match="verify_batch_bls_codes takes an AggBlock"):
        backend.verify_batch_bls_codes(EntryBlock.from_entries([]), device="cpu")
    assert backend.quantized_bucket(5, "bls12381") == 16 and backend.max_coalesce("bls12381") == 16
    assert backend.quantized_bucket(3, "bls12381") == 4
