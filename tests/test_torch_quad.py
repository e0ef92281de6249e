"""The quad point functions, the limb-split field product, the wide field
and the kernels built on them, on the CPU.

csrc/fe25519.cuh's quad functions (quad_double, quad_add_niels,
quad_add, quad_to_niels, quad_cofactor_eq, quad_ristretto_eq) let four
threads of a warp share one point: thread q holds coordinate q of the
point, computes product q of each round with mul/sq, and the quad swaps
the 20-limb products by __shfl_sync. Its split functions (split_mul,
split_sq, split_pow22523, split_sqrt_ratio) let a quad share one field
product: each thread forms five of the 20 limbs, and the quad exchanges
carries and gathers the limbs by shuffles. Its wide field (wide_mul,
wide_sq, wide_pow22523, wide_in, wide_out: 10 limbs of 25.5 bits with
64-bit column sums) carries the chains of the cold K1s and the epoch
table.
CUDA code runs only on the card, where tests/test_torch_cuda.py holds the
whole kernels to their plain versions. Here the header itself is
compiled for the host with the system C++ compiler, against a small
stand-in for the CUDA runtime in which every CUDA thread of one warp is
a fiber and a shuffle waits until every thread of the warp reached it, so the
kernels' split of the products, the coordinate each thread loads and the
exchanges are checked on every run against the plain functions
(ops/point.py and ops/fe.py, themselves held to the JAX package's by
test_torch_point.py and test_torch_fe.py). The same stand-in, with a
launcher that starts each warp of a block's threads, runs the whole
k1_rlc, k1_rlc_cached, k2_rlc, epoch_coords, k1r_decode and k3r_ladder
kernels of csrc/rlc.cu and csrc/sr25519.cu and the k1_decompress,
k2_table and k1_decompress_cached kernels of csrc/verify.cu at a few
lanes, signatures and rows against their plain versions. The wide
field's mad.wide.u32 (WIDE_MAD) is plain C++ here, and counted: the
products one wide operation, one whole cold K1 and one table row form
must equal the counts of chip_smoke.py's bound. The card tests hold the kernels that use it. A
thread that
returns while others wait at a shuffle marks its warp broken: a shuffle
that not every thread reached, which hangs the card, fails the test here
at once instead of hanging it.

Inputs: seeded random limbs in [0, 2^13), eight points (one warp of
eight quads); for the split functions, seeded random limbs over the
carried range [-1216, 2^13 + 1216] with whole elements at either end;
for the wide field, the same, the ends of the range (0, 1, p - 1, p, p +
1, 2p - 1, 2p, 2^255 - 1, 2^256 - 1) through wide_in, and wide limbs fed
straight up to the most a carry leaves in each;
the kernels at 1 and 3 lanes or signatures of random limbs, at 20
sr25519 signatures (chip_smoke.py's ristretto edge battery and 2 padding
rows) and over chip_smoke.py's ZIP-215 edge battery with padding (the
warm K1s at 1 and 3 lanes and at 25 signatures, table columns out of
order; the cold K1s at 1 and 3 lanes and over the whole battery; the
table at 1 row and at 40 rows of the battery's keys, valid keys and
identity padding).
Tolerance: none; every limb of every output is equal, rows 20..31 of
each slot included.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import _edwards
from tendermint_tpu_torch.ops import epoch_cache, fe, kernels, point, rlc, verify
from tendermint_tpu_torch.ops import sr25519 as osr
from tendermint_tpu_torch.ops.entry_block import EntryBlock

torch.set_num_threads(1)

B = 8  # points: one warp of eight quads

# The CUDA runtime as far as the kernels use it, for the host. A warp's
# 32 threads run as fibers (ucontext) on one OS thread, and a shuffle
# switches to the next fiber: once every thread of the warp has reached
# the shuffle, all of them go on. A thread that returns while others wait
# at a shuffle marks the warp broken, and from then on no thread of it
# waits: a shuffle not every thread reaches, which hangs the card, ends
# the launch at once, and the launcher reports it. One warp takes one
# core, whatever the load on the machine, and nothing spins.
SHIM = r"""
#pragma once
#include <cstdint>
#include <functional>
#include <memory>
#include <ucontext.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __restrict__ __restrict
// a block's warps run one after another, and each thread of the op-graph
// kernels reads only its own column of the shared table
#define __shared__ static
#define __constant__
// mad.wide.u32, counted: the tests hold the product counts of the bound
// in chip_smoke.py to the source's
inline thread_local uint64_t emu_wide_mads = 0;
#define WIDE_MAD(a, b, c) \
  (++emu_wide_mads, (uint64_t)(uint32_t)(a) * (uint32_t)(b) + (uint64_t)(c))
extern "C" uint64_t emu_wide_mad_count() { return emu_wide_mads; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx, blockDim;
struct EmuWarp {
  static constexpr size_t kStack = 1 << 18;
  enum { kReady, kAtShuffle, kReturned };
  ucontext_t sched, ctx[32];
  int state[32] = {};
  unsigned nshfl[32] = {};
  bool broken = false;
  int32_t vals[2][32];
  std::function<void(int)> body;
};
inline thread_local EmuWarp* tl_warp;
inline thread_local int tl_lane;
inline void emu_fiber() {
  EmuWarp& w = *tl_warp;
  const int lane = tl_lane;
  w.body(lane);
  w.state[lane] = EmuWarp::kReturned;
}
// Runs body(lane) for the 32 lanes of one warp, lane l as thread
// tid0 + l of its block; 1 where the warp broke, else 0.
template <class F> int emu_warp(F body, unsigned tid0 = 0) {
  EmuWarp w;
  w.body = body;
  std::unique_ptr<char[]> stacks(new char[32 * EmuWarp::kStack]);
  for (int l = 0; l < 32; ++l) {
    getcontext(&w.ctx[l]);
    w.ctx[l].uc_stack.ss_sp = stacks.get() + l * EmuWarp::kStack;
    w.ctx[l].uc_stack.ss_size = EmuWarp::kStack;
    w.ctx[l].uc_link = &w.sched;
    makecontext(&w.ctx[l], emu_fiber, 0);
  }
  tl_warp = &w;
  for (;;) {
    int waiting = 0, returned = 0;
    for (int l = 0; l < 32; ++l) {
      if (w.state[l] == EmuWarp::kReady) {
        tl_lane = l;
        threadIdx = dim3(tid0 + l);
        swapcontext(&w.sched, &w.ctx[l]);
      }
      waiting += w.state[l] == EmuWarp::kAtShuffle;
      returned += w.state[l] == EmuWarp::kReturned;
    }
    if (returned == 32) break;
    if (waiting < 32) w.broken = true;
    for (int l = 0; l < 32; ++l)
      if (w.state[l] == EmuWarp::kAtShuffle) w.state[l] = EmuWarp::kReady;
  }
  return w.broken ? 1 : 0;
}
// Shuffles alternate between two value buffers: a thread writes a buffer
// again only after every thread has reached the shuffle in between, and
// so has read it.
inline int emu_shfl(int v, int src) {
  EmuWarp& w = *tl_warp;
  const int lane = tl_lane;
  if (w.broken) return v;
  int32_t* vals = w.vals[w.nshfl[lane]++ & 1];
  vals[lane] = v;
  w.state[lane] = EmuWarp::kAtShuffle;
  swapcontext(&w.ctx[lane], &w.sched);
  return w.broken ? v : vals[src];
}
inline int __shfl_sync(unsigned, int v, int src, int width) {
  return emu_shfl(v, (tl_lane & ~(width - 1)) + (src & (width - 1)));
}
inline int __shfl_xor_sync(unsigned, int v, int m, int width) {
  return emu_shfl(v, (tl_lane & ~(width - 1)) + ((tl_lane ^ m) & (width - 1)));
}
// a barrier of the warp: every thread waits until all 32 reached it
inline void __syncwarp(unsigned = 0xffffffffu) { emu_shfl(0, tl_lane); }
// warps run one after another: an atomic add is a plain one
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}
"""

# op 0: quad_double, 1: quad_add_niels, 2: quad_cofactor_eq, 3: quad_add,
# 4: quad_to_niels, 5: quad_ristretto_eq over (4, 20, b) arrays; thread
# 4k + q works on coordinate q of point k. emu_split: op 0 split_mul, 1
# split_sq, 2 split_pow22523 on one warp of eight quads, quad k on column
# k of (20, 8) arrays; thread q of the quad writes the result in order
# (split_u) and as it holds it (rotated by 5q limbs) to out (4, 2, 20, 8).
# Each returns 1 where a warp broke (a shuffle not every thread reached),
# else 0.
HARNESS = r"""
#include "fe25519.cuh"
using namespace edw;
static fe load(const int32_t* p, int c, int k, int b) {
  fe x;
  for (int l = 0; l < NL; ++l) x.v[l] = p[(c * NL + l) * b + k];
  return x;
}
extern "C" int emu_quad(int op, int need_t, const int32_t* pts, const int32_t* ents,
                        int32_t* out, int b) {
  return emu_warp([=](int tid) {
      const int q = tid & 3, k = tid >> 2;
      const fe c = load(pts, q, k, b);
      if (op == 2 || op == 5) {
        const bool eq = op == 2 ? quad_cofactor_eq(c, load(ents, q, k, b), q)
                                : quad_ristretto_eq(c, load(ents, ristretto_coord(q), k, b), q);
        if (q == 0) out[k] = eq ? 1 : 0;
        return;
      }
      const fe r = op == 0 ? quad_double(c, q, need_t != 0)
                   : op == 1 ? quad_add_niels(c, load(ents, niels_coord(q), k, b), q, need_t != 0)
                   : op == 3 ? quad_add(c, load(ents, q, k, b), q)
                             : quad_to_niels(c, q);
      for (int l = 0; l < NL; ++l) out[(q * NL + l) * b + k] = r.v[l];
    });
}
extern "C" int emu_split(int op, const int32_t* a, const int32_t* b, int32_t* out) {
  return emu_warp([=](int tid) {
      const int q = tid & 3, k = tid >> 2;
      const fe x = load(a, 0, k, 8), y = load(b, 0, k, 8);
      const fe r = op == 0 ? split_mul(x, split_rot(y, q), q)
                   : op == 1 ? split_sq(split_rot(x, q), q)
                             : split_pow22523(split_rot(x, q), q);
      const fe u = split_u(r);
      for (int l = 0; l < NL; ++l) {
        out[((q * 2 + 0) * NL + l) * 8 + k] = u.v[l];
        out[((q * 2 + 1) * NL + l) * 8 + k] = r.v[l];
      }
    });
}
// split_sqrt_ratio(u, v) on one warp of eight quads, quad k on column k
// of (20, 8) arrays; thread q of the quad writes r to r_out (4, 20, 8)
// and its flag to ok_out (4, 8).
extern "C" int emu_sqrt_ratio(const int32_t* u, const int32_t* v, int32_t* r_out,
                              int32_t* ok_out) {
  return emu_warp([=](int tid) {
      const int q = tid & 3, k = tid >> 2;
      const auto uv = [&](fe& uu, fe& vr) {
        uu = load(u, 0, k, 8);
        vr = split_rot(load(v, 0, k, 8), q);
      };
      fe r;
      const bool ok = split_sqrt_ratio(r, uv, q);
      for (int l = 0; l < NL; ++l) r_out[(q * NL + l) * 8 + k] = r.v[l];
      ok_out[q * 8 + k] = ok ? 1 : 0;
    });
}
// The wide field on n elements, one after another (no warp), element k
// in column k: op 0 wide_mul, 1 wide_sq, 2 wide_pow22523 of x (and y), 3
// x alone, 4 wide_fold of x, written to the 20 limbs lo by wide_out. x and y are wide_in of
// the 13-bit limbs la and lb (20, n) or, where wa is given, the 10 wide
// limbs wa and wb (10, n) as they are.
extern "C" void emu_wide(int op, const int32_t* la, const int32_t* lb, const uint32_t* wa,
                         const uint32_t* wb, int32_t* lo, int n) {
  for (int k = 0; k < n; ++k) {
    fw x, y;
    if (wa) {
      for (int i = 0; i < NWL; ++i) x.v[i] = wa[i * n + k], y.v[i] = wb[i * n + k];
    } else {
      x = wide_in(load(la, 0, k, n));
      y = wide_in(load(lb, 0, k, n));
    }
    const fw r = op == 0 ? wide_mul(x, y)
                 : op == 1 ? wide_sq(x)
                 : op == 2 ? wide_pow22523(x)
                 : op == 4 ? wide_fold(x)
                           : x;
    const fe f = wide_out(r);
    for (int l = 0; l < NL; ++l) lo[l * n + k] = f.v[l];
  }
}
// The wide quad point functions on one warp of eight quads, thread 4k + q
// on coordinate q of point k of (4, 10, b) wide limbs: op 0
// wquad_double, 1 wquad_add_niels (thread q taking Niels coordinate
// niels_coord(q) of ents), 2 wquad_cofactor_identity (to out[k]), 3
// wquad_add, 4 wquad_to_niels; thread q writes coordinate q of the result,
// folded, as canonical limbs (wide_out) to out (4, 20, b).
static fw wload(const uint32_t* p, int c, int k, int b) {
  fw x;
  for (int i = 0; i < NWL; ++i) x.v[i] = p[(c * NWL + i) * b + k];
  return x;
}
extern "C" int emu_wquad(int op, int need_t, const uint32_t* pts, const uint32_t* ents,
                         int32_t* out, int b) {
  return emu_warp([=](int tid) {
      const int q = tid & 3, k = tid >> 2;
      const fw c = wload(pts, q, k, b);
      if (op == 2) {
        const bool z = wquad_cofactor_identity(c, q);
        if (q == 0) out[k] = z ? 1 : 0;
        return;
      }
      const fw r = op == 0 ? wquad_double(c, q, need_t != 0)
                   : op == 1 ? wquad_add_niels(c, wload(ents, niels_coord(q), k, b), q,
                                               need_t != 0)
                   : op == 3 ? wquad_add(c, wload(ents, q, k, b), q)
                             : wquad_to_niels(c, q);
      const fe f = wide_out(wide_fold(r));
      for (int l = 0; l < NL; ++l) out[(q * NL + l) * b + k] = f.v[l];
    });
}
// wide_decompress of n rows of 32 bytes, one after another: x, y, t as
// canonical limbs to out (3, 20, n), the flag to ok (n,).
extern "C" void emu_wide_decompress(const uint8_t* rows, int32_t* out, int32_t* ok, int n) {
  for (int k = 0; k < n; ++k) {
    fw x, y, t;
    ok[k] = wide_decompress(x, y, t, rows + 32 * k) ? 1 : 0;
    const fw c[3] = {x, y, t};
    for (int j = 0; j < 3; ++j) {
      const fe f = wide_out(wide_fold(c[j]));
      for (int l = 0; l < NL; ++l) out[(j * NL + l) * n + k] = f.v[l];
    }
  }
}
// A warp whose lane 5 leaves before the quad's shuffle: the stand-in must
// report it.
extern "C" int emu_stray_lane() {
  return emu_warp([](int tid) {
    if (tid != 5) quad_slot(fe_one(), 0);
  });
}
"""

# The kernels of rlc.cu and sr25519.cu, and in a library of its own (its
# constants share names with rlc.cu's) those of verify.cu, each cut above
# its C interface, whose <<<>>> launches are CUDA syntax, launched warp by
# warp: the 32 threads of a warp run together, one warp after another.
# Each launcher returns 1 where a warp broke, else 0.
LAUNCH = r"""
template <class F> static int launch(dim3 grid, int threads, F body) {
  int broken = 0;
  blockDim = dim3(threads);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      for (int w = 0; w < threads / 32; ++w)
        broken |= emu_warp([=](int) { body(); }, w * 32);
    }
  return broken;
}
"""

KERNEL_HARNESS = r"""
#include "rlc_body.cu"
#include "sr25519_body.cu"
using namespace edw;
""" + LAUNCH + r"""
extern "C" int emu_k2_rlc(const int32_t* coords, int32_t* tbl, int g) {
  return launch(dim3((4 * g + K2_THREADS - 1) / K2_THREADS, M), K2_THREADS,
                [=] { k2_rlc_kernel(coords, tbl, g); });
}
extern "C" int emu_k1_rlc_cached(const int32_t* ctbl, const int32_t* oktbl, const int32_t* idx,
                                 const uint8_t* r_rows, const uint8_t* scal_rows, int32_t* coords,
                                 int32_t* ok, int32_t* dig, int g, int vp) {
  return launch(dim3((4 * g + K1C_THREADS - 1) / K1C_THREADS, M), K1C_THREADS, [=] {
    k1_rlc_cached_kernel(ctbl, oktbl, idx, r_rows, scal_rows, coords, ok, dig, g, vp);
  });
}
extern "C" int emu_k1_rlc(const uint8_t* a_t, const uint8_t* r_t, const uint8_t* scal_t,
                          int32_t* coords, int32_t* ok, int32_t* dig, int g) {
  return launch(dim3((g + THREADS - 1) / THREADS, N_SCAL), THREADS,
                [=] { k1_rlc_kernel(a_t, r_t, scal_t, coords, ok, dig, g); });
}
extern "C" int emu_epoch_coords(const uint8_t* pub_t, int32_t* coords, int32_t* ok, int vp) {
  return launch(dim3((vp + THREADS - 1) / THREADS), THREADS,
                [=] { epoch_coords_kernel(pub_t, coords, ok, vp); });
}
extern "C" int emu_k1r_decode(const uint8_t* a_t, const uint8_t* r_t, const uint8_t* s_t,
                              const uint8_t* k_t, const int32_t* aok, const int32_t* rok,
                              int32_t* coords, int32_t* ok, int32_t* sdig, int32_t* kdig, int n) {
  return launch(sig_grid(n, 2), VTHREADS, [=] {
    k1r_decode_kernel(a_t, r_t, s_t, k_t, aok, rok, coords, ok, sdig, kdig, n);
  });
}
extern "C" int emu_k3r_ladder(const int32_t* tbl, const int32_t* sdig, const int32_t* kdig,
                              const int32_t* coords, const int32_t* ok, const int32_t* sok,
                              int32_t* out, int n) {
  return launch(dim3((4 * n + K3R_THREADS - 1) / K3R_THREADS), K3R_THREADS,
                [=] { k3r_ladder_kernel(tbl, sdig, kdig, coords, ok, sok, out, n); });
}
"""

VERIFY_HARNESS = r"""
#include "verify_body.cu"
using namespace edw;
""" + LAUNCH + r"""
extern "C" int emu_k2_table(const int32_t* coords, int32_t* tbl, int n) {
  return launch(dim3((4 * n + K2_THREADS - 1) / K2_THREADS), K2_THREADS,
                [=] { k2_table_kernel(coords, tbl, n); });
}
extern "C" int emu_k1_decompress(const uint8_t* a_t, const uint8_t* r_t, const uint8_t* s_t,
                                 const uint8_t* k_t, int32_t* coords, int32_t* ok,
                                 int32_t* sdig, int32_t* kdig, int n) {
  return launch(sig_grid(n, 2), VTHREADS, [=] {
    k1_decompress_kernel(a_t, r_t, s_t, k_t, coords, ok, sdig, kdig, n);
  });
}
extern "C" int emu_k1_decompress_cached(const int32_t* ctbl, const int32_t* oktbl,
                                        const int32_t* idx, const uint8_t* r_rows,
                                        const uint8_t* s_rows, const uint8_t* k_rows,
                                        int32_t* coords, int32_t* ok, int32_t* sdig,
                                        int32_t* kdig, int n, int vp) {
  return launch(dim3((4 * n + K1C_THREADS - 1) / K1C_THREADS), K1C_THREADS, [=] {
    k1_decompress_cached_kernel(ctbl, oktbl, idx, r_rows, s_rows, k_rows, coords, ok, sdig,
                                kdig, n, vp);
  });
}
"""


OG_HARNESS = r"""
#include "sha512_body.cu"
#include "ed25519_verify_body.cu"
using namespace edw;
""" + LAUNCH + r"""
extern "C" int emu_sha512_challenge(const uint32_t* hi, const uint32_t* lo, const int32_t* nb,
                                    uint8_t* out, int n, int nblock) {
  return launch(dim3((n + sha::THREADS - 1) / sha::THREADS), sha::THREADS,
                [=] { sha::sha512_challenge_kernel(hi, lo, nb, out, n, nblock); });
}
extern "C" int emu_og_verify(const uint8_t* a, const uint8_t* r, const uint8_t* s,
                             const uint8_t* k, const int32_t* s_ok, int32_t* out, int n) {
  return launch(dim3((4 * n + OG_THREADS - 1) / OG_THREADS), OG_THREADS,
                [=] { og_verify_kernel(a, r, s, k, s_ok, out, n); });
}
extern "C" int emu_og_verify_cached(const int32_t* ctbl, const int32_t* oktbl, const int32_t* idx,
                                    const uint8_t* r, const uint8_t* s, const uint8_t* k,
                                    const int32_t* s_ok, int32_t* out, int n, int vp) {
  return launch(dim3((4 * n + OG_THREADS - 1) / OG_THREADS), OG_THREADS,
                [=] { og_verify_cached_kernel(ctbl, oktbl, idx, r, s, k, s_ok, out, n, vp); });
}
"""


def _compile(cxx, d, src: str, lib: str):
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w", f"-I{d}", f"-I{kernels.CSRC}",
         "-o", str(d / lib), str(d / src), "-lpthread"],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(d / lib))


def _emu_dir(tmp_path_factory, name):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp(name)
    (d / "cuda_runtime.h").write_text(SHIM)
    return cxx, d


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    cxx, d = _emu_dir(tmp_path_factory, "quad_emu")
    (d / "harness.cpp").write_text(HARNESS)
    lib = _compile(cxx, d, "harness.cpp", "libquad_emu.so")
    lib.emu_quad.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.emu_split.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.emu_sqrt_ratio.argtypes = [ctypes.c_void_p] * 4
    lib.emu_wide.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
    lib.emu_wquad.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.emu_wide_decompress.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.emu_wide_mad_count.restype = ctypes.c_uint64
    return lib


@pytest.fixture(scope="module")
def emu(emu_lib):
    return emu_lib.emu_quad


def _kernel_lib(tmp_path_factory, name, sources, harness):
    cxx, d = _emu_dir(tmp_path_factory, name)
    for src in sources:
        text = (kernels.CSRC / f"{src}.cu").read_text()
        (d / f"{src}_body.cu").write_text(text.split("// ---- C interface")[0])
    (d / "harness.cpp").write_text(harness)
    return _compile(cxx, d, "harness.cpp", f"lib{name}.so")


@pytest.fixture(scope="module")
def emu_kernels(tmp_path_factory):
    lib = _kernel_lib(tmp_path_factory, "kernel_emu", ("rlc", "sr25519"), KERNEL_HARNESS)
    lib.emu_k2_rlc.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.emu_k3r_ladder.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int]
    lib.emu_k1_rlc_cached.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
    lib.emu_k1r_decode.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int]
    lib.emu_k1_rlc.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    lib.emu_epoch_coords.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.emu_wide_mad_count.restype = ctypes.c_uint64
    return lib


@pytest.fixture(scope="module")
def emu_verify(tmp_path_factory):
    lib = _kernel_lib(tmp_path_factory, "verify_emu", ("verify",), VERIFY_HARNESS)
    lib.emu_k2_table.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.emu_k1_decompress_cached.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
    lib.emu_k1_decompress.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int]
    lib.emu_wide_mad_count.restype = ctypes.c_uint64
    return lib


TALLY_HARNESS = r"""
#include "tally_body.cu"
""" + LAUNCH + r"""
extern "C" int emu_commit_tally(const int32_t* valid, const int32_t* live, const int32_t* power,
                                unsigned long long* out, int rows, int m) {
  return launch(dim3((rows + tally::THREADS - 1) / tally::THREADS), tally::THREADS,
                [=] { tally::commit_tally_kernel(valid, live, power, out, rows, m); });
}
"""


@pytest.fixture(scope="module")
def emu_og(tmp_path_factory):
    lib = _kernel_lib(tmp_path_factory, "og_emu", ("sha512", "ed25519_verify"), OG_HARNESS)
    lib.emu_sha512_challenge.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    lib.emu_og_verify.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    lib.emu_og_verify_cached.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
    lib.emu_wide_mad_count.restype = ctypes.c_uint64
    return lib


def _points(seed: int):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 1 << 13, (fe.NLIMBS, B), dtype=np.int32))
                 for _ in range(4))


def _run(emu, op: int, need_t: bool, p, q=None):
    pts = torch.stack(p).contiguous()
    ents = torch.stack(q).contiguous() if q is not None else torch.zeros_like(pts)
    out = torch.full((4, fe.NLIMBS, B), -1, dtype=torch.int32)
    assert emu(op, int(need_t), pts.data_ptr(), ents.data_ptr(), out.data_ptr(), B) == 0
    return out


@pytest.mark.parametrize("need_t", [True, False])
def test_quad_double_equals_point_double(emu, need_t):
    p = _points(1)
    want = torch.stack(point.point_double(p, need_t=need_t))
    assert torch.equal(_run(emu, 0, need_t, p), want)


@pytest.mark.parametrize("need_t", [True, False])
def test_quad_add_niels_equals_point_add_niels(emu, need_t):
    p, q = _points(2), _points(3)
    want = torch.stack(point.point_add_niels(p, q, need_t=need_t))
    assert torch.equal(_run(emu, 1, need_t, p, q), want)


def test_quad_cofactor_eq_equals_the_plain_test(emu):
    """[8]acc == [8]R against k3's plain test, on pairs that are the same
    projective point (R = lambda * acc, coordinate by coordinate) in the
    even columns and unrelated in the odd ones."""
    acc = _points(4)
    lam = fe.from_int(123456789, acc[0])
    r = tuple(torch.where(torch.arange(B) % 2 == 0, fe.mul(c, lam), o)
              for c, o in zip(acc, _points(5)))
    a8, r8 = acc, r
    for _ in range(3):
        a8 = point.point_double(a8, need_t=False)
        r8 = point.point_double(r8, need_t=False)
    want = (fe.is_zero(fe.sub(fe.mul(a8[0], r8[2]), fe.mul(r8[0], a8[2])))
            & fe.is_zero(fe.sub(fe.mul(a8[1], r8[2]), fe.mul(r8[1], a8[2]))))
    got = _run(emu, 2, False, acc, r)[0, 0]
    assert got.tolist() == want[0].int().tolist() == [1, 0] * (B // 2)


def test_quad_add_equals_point_add(emu):
    """quad_add against point.point_add on unrelated points, and with
    P = Q (the case the unified formula exists for)."""
    p, q = _points(6), _points(7)
    assert torch.equal(_run(emu, 3, True, p, q), torch.stack(point.point_add(p, q)))
    assert torch.equal(_run(emu, 3, True, p, p), torch.stack(point.point_add(p, p)))


def test_quad_to_niels_equals_to_niels(emu):
    p = _points(8)
    assert torch.equal(_run(emu, 4, False, p), torch.stack(point.to_niels(p)))


def test_quad_ristretto_eq_equals_the_plain_test(emu):
    """acc == R in the ristretto group against sr25519.ristretto_eq, with
    R = lambda * acc (the X yR == Y xR branch) in columns 0, 3, 6; R =
    lambda * (i Y, i X), the translate of acc by the 4-torsion point
    (sqrt(-1), 0) (only the Y yR == X xR branch), in 1, 4, 7; unrelated
    points in 2, 5."""
    acc = _points(9)
    lam = fe.from_int(987654321, acc[0])
    i_lam = fe.mul(lam, fe.from_int(_edwards.SQRT_M1, acc[0]))
    other = _points(10)
    col = torch.arange(B) % 3
    rx = torch.where(col == 0, fe.mul(acc[0], lam),
                     torch.where(col == 1, fe.mul(acc[1], i_lam), other[0]))
    ry = torch.where(col == 0, fe.mul(acc[1], lam),
                     torch.where(col == 1, fe.mul(acc[0], i_lam), other[1]))
    want = osr.ristretto_eq(acc, rx, ry)
    eq1 = fe.is_zero(fe.sub(fe.mul(acc[0], ry), fe.mul(acc[1], rx)))
    assert eq1[0].tolist() == (col == 0).tolist()
    assert want[0].tolist() == (col != 2).tolist()
    got = _run(emu, 5, False, acc, (rx, ry, rx, ry))[0, 0]
    assert got.tolist() == want[0].int().tolist()


@pytest.mark.parametrize("lanes", [1, 3])
def test_k2_rlc_kernel_equals_plain(emu_kernels, lanes):
    """The whole quad k2_rlc kernel against k2_rlc_plain on random
    coordinates, every row of the table: the limbs and the zero rows
    20..31 of each slot (the output starts as -1, as torch.empty may
    leave it). 1 and 3 lanes leave most quads of the block past the end."""
    rng = np.random.default_rng(lanes)
    coords = torch.from_numpy(rng.integers(0, 1 << 13, (rlc.COORD_ROWS, lanes), dtype=np.int32))
    want = rlc.k2_rlc_plain(coords)
    got = torch.full_like(want, -1)
    assert emu_kernels.emu_k2_rlc(coords.data_ptr(), got.data_ptr(), lanes) == 0
    assert torch.equal(got, want)


def test_k3r_ladder_kernel_equals_plain(emu_kernels):
    """The whole quad k3r_ladder kernel against k3r_ladder_plain over
    chip_smoke.py's ristretto edge battery (valid and tampered signatures,
    keys and R that do not decode, the identity key, no marker, s >= L)
    and 2 padding rows (the all-zero identity, every flag 1): 20
    signatures, so the second block's quads run on a clamped column."""
    import chip_smoke

    ents = chip_smoke.sr_edge_entries()
    n = len(ents) + 2
    args = [torch.from_numpy(a) for a in osr.prepare_sr25519(EntryBlock.from_entries(ents), n)]
    coords, ok, sdig, kdig = osr.k1r_decode_plain(*args[:6])
    tbl = verify.k2_table_plain(coords)
    want = osr.k3r_ladder_plain(tbl, sdig, kdig, coords, ok, args[6])
    assert 0 < int(want.sum()) < n and want[0, -2:].tolist() == [1, 1]
    ins = [x.contiguous() for x in (tbl, sdig, kdig, coords, ok, args[6])]
    got = torch.full_like(want, -1)
    assert emu_kernels.emu_k3r_ladder(*(x.data_ptr() for x in ins), got.data_ptr(), n) == 0
    assert torch.equal(got, want)


def _raw_equal(got, want) -> None:
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lanes", [1, 3])
def test_k1_rlc_cached_kernel_equals_plain(emu_kernels, lanes):
    """The whole k1_rlc_cached kernel (a quad per (lane, slot) on the
    split field product) against k1_rlc_cached_plain over the last 4 lanes
    - 1 entries of chip_smoke.py's ZIP-215 edge battery (at 3 lanes:
    non-canonical and small-order keys, a key off the curve, a corrupted
    key, s >= L, random bytes whose R do not decompress) and a padding
    signature on column vp - 1, with the table's columns out of order:
    every output raw, rows 20..31 of each coordinate slot included, each
    output starting as -1. 1 and 3 lanes leave most quads of each block
    past the end."""
    import chip_smoke

    ents = chip_smoke.edge_entries()[-(4 * lanes - 1):]
    block, ep = chip_smoke.with_epoch(EntryBlock.from_entries(ents), 8 + lanes)
    idx, r_rows, scal_rows, _ = (torch.from_numpy(a)
                                 for a in rlc.prepare_rlc_cached(block, 4 * lanes, ep))
    assert idx[-1] == ep.vp - 1 and idx[:-1].tolist() != sorted(idx[:-1].tolist())
    ctbl, oktbl = epoch_cache.epoch_coords_plain(
        torch.from_numpy(np.ascontiguousarray(ep.pub_rows.T)))
    want = rlc.k1_rlc_cached_plain(ctbl, oktbl, idx, r_rows, scal_rows)
    got = tuple(torch.full_like(w, -1) for w in want)
    ins = [x.contiguous() for x in (ctbl, oktbl, idx, r_rows, scal_rows)]
    assert emu_kernels.emu_k1_rlc_cached(
        *(x.data_ptr() for x in ins), *(g.data_ptr() for g in got), lanes, ep.vp) == 0
    _raw_equal(got, want)
    if lanes > 1:
        ok_a, ok_r = want[1][: rlc.M].flatten().tolist(), want[1][rlc.M :].flatten().tolist()
        assert 0 in ok_a and 1 in ok_a and 0 in ok_r and 1 in ok_r


def test_k1r_decode_kernel_equals_plain(emu_kernels):
    """The whole k1r_decode kernel (a thread per (signature, point) on the
    inline ristretto decode) against k1r_decode_plain over chip_smoke.py's
    ristretto edge battery (odd keys, p + 1, bit 255 set, 1 + s^2 = 0, not
    square, an odd t, an R that does not decode, the identity key) and 2
    padding rows (the all-zero identity, every flag 1): every output raw,
    rows 20..31 of each coordinate slot included, each output starting as
    -1, so a row the kernel leaves unwritten shows."""
    import chip_smoke

    ents = chip_smoke.sr_edge_entries()
    n = len(ents) + 2
    args = [torch.from_numpy(a).contiguous()
            for a in osr.prepare_sr25519(EntryBlock.from_entries(ents), n)][:6]
    want = osr.k1r_decode_plain(*args)
    got = tuple(torch.full_like(w, -1) for w in want)
    assert emu_kernels.emu_k1r_decode(
        *(x.data_ptr() for x in args), *(g.data_ptr() for g in got), n) == 0
    _raw_equal(got, want)
    ok = want[1][:, : len(ents)].flatten().tolist()
    assert 0 in ok and 1 in ok and want[1][:, -2:].all()


# -- the limb-split field product and the verify.cu kernels -------------------

LO, HI = -1216, (1 << 13) + 1216  # the carried range's ends


def _split_inputs(seed: int, g: int):
    """(20, g) int32 a and b: random limbs over [LO, HI], with column 0 of
    a all LO, column 1 all HI and column 2 alternating."""
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(LO, HI + 1, (fe.NLIMBS, g), dtype=np.int32) for _ in range(2))
    a[:, 0], a[:, 1] = LO, HI
    a[:, 2] = np.where(np.arange(fe.NLIMBS) % 2 == 0, LO, HI)
    b[:, 1] = HI
    return torch.from_numpy(a), torch.from_numpy(b)


def _split_run(emu_lib, op: int, a, b):
    """emu_split's output as (4, 2, 20, 8): thread q's u and r."""
    out = torch.full((4, 2, fe.NLIMBS, 8), -1, dtype=torch.int32)
    assert emu_lib.emu_split(op, a.contiguous().data_ptr(), b.contiguous().data_ptr(),
                             out.data_ptr()) == 0
    return out


def _assert_split(out, want):
    """Every thread q of every quad holds want rotated by 5q limbs, and
    receives it in order from split_u."""
    for q in range(4):
        assert torch.equal(out[q, 0], want)
        assert torch.equal(out[q, 1], torch.roll(want, -5 * q, dims=0))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_split_mul_equals_fe_mul(emu_lib, seed):
    a, b = _split_inputs(seed, 8)
    _assert_split(_split_run(emu_lib, 0, a, b), fe.mul(a, b))


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_split_sq_equals_fe_sq(emu_lib, seed):
    a, b = _split_inputs(seed, 8)
    _assert_split(_split_run(emu_lib, 1, a, b), fe.sq(a))


@pytest.mark.parametrize("seed", [31, 32])
def test_quad_pow22523_equals_fe_pow22523(emu_lib, seed):
    a, b = _split_inputs(seed, 8)
    _assert_split(_split_run(emu_lib, 2, a, b), fe.pow22523(a))


def test_split_sqrt_ratio_equals_sqrt_ratio(emu_lib):
    """split_sqrt_ratio on the quad against point.sqrt_ratio: r (every
    thread holds it in order) and the flag, on limbs over the carried
    range, with square ratios on either branch (v r^2 = u before the
    sqrt(-1) product, and -u) and non-square ones among them."""
    u, v = _split_inputs(54, 8)
    want_ok, want_r = point.sqrt_ratio(u, v)
    r = torch.full((4, fe.NLIMBS, 8), -1, dtype=torch.int32)
    ok = torch.full((4, 8), -1, dtype=torch.int32)
    assert emu_lib.emu_sqrt_ratio(u.contiguous().data_ptr(), v.contiguous().data_ptr(),
                                  r.data_ptr(), ok.data_ptr()) == 0
    for q in range(4):
        assert torch.equal(r[q], want_r)
        assert ok[q].tolist() == want_ok[0].int().tolist()
    v3 = fe.mul(fe.sq(v), v)
    r0 = fe.mul(fe.mul(u, v3), fe.pow22523(fe.mul(u, fe.mul(fe.sq(v3), v))))
    pos = fe.eq(fe.mul(v, fe.sq(r0)), u)  # v r^2 = u before the sqrt(-1) product
    assert {(bool(a), bool(b)) for a, b in zip(want_ok[0], pos[0])} == {
        (True, True), (True, False), (False, False)}


def test_stand_in_reports_a_shuffle_not_every_thread_reaches(emu_lib):
    """A warp in which one thread leaves before a shuffle: on the card
    that is undefined (a hang, at worst); the stand-in stops waiting as
    soon as no thread is left to reach the shuffle, and reports the warp
    broken."""
    assert emu_lib.emu_stray_lane() == 1


def _k2_table(emu_verify, coords):
    n = coords.shape[-1]
    got = torch.full((verify.TBL_ROWS, n), -1, dtype=torch.int32)
    assert emu_verify.emu_k2_table(coords.contiguous().data_ptr(), got.data_ptr(), n) == 0
    return got


@pytest.mark.parametrize("n", [1, 3])
def test_k2_table_kernel_equals_plain(emu_verify, n):
    """The whole quad k2_table kernel against k2_table_plain on random
    coordinates, every row of the table: the limbs and the zero rows
    20..31 of each slot (the output starts as -1, as torch.empty may
    leave it). 1 and 3 signatures leave most quads of the block past the
    end."""
    rng = np.random.default_rng(40 + n)
    coords = torch.from_numpy(rng.integers(0, 1 << 13, (verify.COORD_ROWS, n), dtype=np.int32))
    assert torch.equal(_k2_table(emu_verify, coords), verify.k2_table_plain(coords))


def test_k2_table_kernel_on_k1r_coordinates(emu_verify):
    """k2_table on the sr25519 path's input: K1r's coordinates over
    chip_smoke.py's ristretto edge battery and 2 padding rows."""
    import chip_smoke

    ents = chip_smoke.sr_edge_entries()
    n = len(ents) + 2
    args = [torch.from_numpy(a) for a in osr.prepare_sr25519(EntryBlock.from_entries(ents), n)]
    coords = osr.k1r_decode_plain(*args[:6])[0]
    assert torch.equal(_k2_table(emu_verify, coords), verify.k2_table_plain(coords))


def test_k1_decompress_cached_kernel_equals_plain(emu_verify):
    """The whole k1_decompress_cached kernel (a quad per signature on the
    split field product) against its plain version over chip_smoke.py's
    ZIP-215 edge battery (non-canonical y, the sqrt(-1) branch, keys and
    R that do not decompress) and 4 padding signatures on column vp - 1,
    with the table's columns out of order: every output raw, rows 20..31
    of each coordinate slot included, each output starting as -1. The
    count leaves quads of the last warp past the end."""
    import chip_smoke

    ents = chip_smoke.edge_entries()
    n = len(ents) + 4
    assert n % 8
    block, ep = chip_smoke.with_epoch(EntryBlock.from_entries(ents), 7)
    idx, r_rows, s_rows, k_rows, _ = (torch.from_numpy(a)
                                      for a in verify.prepare_compact_cached(block, n, ep))
    assert idx[-1] == ep.vp - 1 and idx[: len(ents)].tolist() != sorted(idx[: len(ents)].tolist())
    ctbl, oktbl = epoch_cache.epoch_coords_plain(
        torch.from_numpy(np.ascontiguousarray(ep.pub_rows.T)))
    want = verify.k1_decompress_cached_plain(ctbl, oktbl, idx, r_rows, s_rows, k_rows)
    got = tuple(torch.full_like(w, -1) for w in want)
    ins = [x.contiguous() for x in (ctbl, oktbl, idx, r_rows, s_rows, k_rows)]
    assert emu_verify.emu_k1_decompress_cached(
        *(x.data_ptr() for x in ins), *(g.data_ptr() for g in got), n, ep.vp) == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ok_r = want[1][1, : len(ents)].tolist()
    assert 0 in ok_r and 1 in ok_r


# -- the wide field and the cold K1s on it --------------------------------------

# values at the ends of the range, into wide_in as 13-bit limbs: p and 2p
# reduce to 0, and 2^256 - 1 = 2p + 37
EDGE_VALUES = [0, 1, fe.P - 1, fe.P, fe.P + 1, 2 * fe.P - 1, 2 * fe.P, 2**255 - 1, 2**256 - 1]
WIDE_BITS = [25 if i & 1 else 26 for i in range(10)]
WIDE_AT = [25 * i + (i + 1) // 2 for i in range(10)]
# the most each wide limb holds as wide_carry leaves it: limbs 1 and 5 take
# the carries of the second passes over limbs 0 and 4
WIDE_TOP = [(1 << b) - 1 + (1 << 15) * (i in (1, 5)) for i, b in enumerate(WIDE_BITS)]


def _wide_split(v: int) -> list:
    """A value below 2^255 -> its 10 wide limbs, each within its width."""
    return [(v >> at) & ((1 << b) - 1) for at, b in zip(WIDE_AT, WIDE_BITS)]


def _wide_value(limbs) -> int:
    return sum(int(x) << at for x, at in zip(limbs, WIDE_AT))


def _wide_limb_sets() -> list:
    """Wide limbs fed straight to the wide functions: 0, 1, p - 1, p, p + 1,
    2^255 - 1 (every limb full), every limb at WIDE_TOP (the value 2^255 +
    2^143 + ...), and 8 seeded random sets up to WIDE_TOP."""
    rng = np.random.default_rng(67)
    sets = [_wide_split(v) for v in (0, 1, fe.P - 1, fe.P, fe.P + 1, 2**255 - 1)]
    sets.append(WIDE_TOP)
    sets += [[int(rng.integers(0, t + 1)) for t in WIDE_TOP] for _ in range(8)]
    return sets


def _wide_inputs(kind: str) -> tuple:
    """(a, b, wa, wb): 13-bit limbs (20, n) over the carried range with
    whole columns at its ends (_split_inputs) or every pair of EDGE_VALUES,
    with wa, wb None; or ("limbs") every pair of _wide_limb_sets as wide
    limbs (10, n), with a, b the 13-bit limbs of the same values."""
    if kind == "random":
        a, b = _split_inputs(66, 16)
        return a, b, None, None
    if kind == "edge":
        a = [x for x in EDGE_VALUES for _ in EDGE_VALUES]
        b = [y for _ in EDGE_VALUES for y in EDGE_VALUES]
        return fe.from_ints(a), fe.from_ints(b), None, None
    sets = _wide_limb_sets()
    wa = np.array([x for x in sets for _ in sets], dtype=np.uint32).T.copy()
    wb = np.array([y for _ in sets for y in sets], dtype=np.uint32).T.copy()
    return (fe.from_ints([_wide_value(c) for c in wa.T]),
            fe.from_ints([_wide_value(c) for c in wb.T]), wa, wb)


def _wide(emu_lib, op: int, a, b, wa=None, wb=None):
    got = torch.full(a.shape, -1, dtype=torch.int32)
    emu_lib.emu_wide(op, a.contiguous().data_ptr(), b.contiguous().data_ptr(),
                     None if wa is None else wa.ctypes.data,
                     None if wb is None else wb.ctypes.data, got.data_ptr(), a.shape[-1])
    return got


@pytest.mark.parametrize("kind", ["random", "edge", "limbs"])
@pytest.mark.parametrize("op", ["mul", "sq", "pow22523"])
def test_wide_field_equals_fe(emu_lib, op, kind):
    """wide_mul, wide_sq and wide_pow22523, on wide_in of 13-bit limbs or
    on wide limbs fed straight, written out by wide_out, against ops/fe.py's
    mul, sq and pow22523 on the same values: every canonical limb equal."""
    a, b, wa, wb = _wide_inputs(kind)
    if op == "mul":
        got, want = _wide(emu_lib, 0, a, b, wa, wb), fe.mul(a, b)
    elif op == "sq":
        got, want = _wide(emu_lib, 1, a, b, wa, wb), fe.sq(a)
    else:
        got, want = _wide(emu_lib, 2, a, b, wa, wb), fe.pow22523(a)
    assert torch.equal(got, fe.canon(want))


@pytest.mark.parametrize("kind", ["random", "edge", "limbs"])
def test_wide_conversions_equal_canon(emu_lib, kind):
    """wide_out(wide_in(x)) -> fe.canon(x), every limb, on 13-bit limbs
    over the carried range and at the ends of the range (p and 2p in, 0
    out); and wide_out of wide limbs fed straight, up to WIDE_TOP (values
    from p to 2^255 + 2^143 reduce by one p), -> fe.canon of their value."""
    a, b, wa, wb = _wide_inputs(kind)
    assert torch.equal(_wide(emu_lib, 3, a, b, wa, wb), fe.canon(a))


def _wide_mads(lib, fn) -> int:
    """WIDE_MAD products that fn() formed in lib."""
    before = lib.emu_wide_mad_count()
    fn()
    return lib.emu_wide_mad_count() - before


@pytest.mark.parametrize("op", ["mul", "sq", "pow22523"])
def test_wide_products_equal_the_bounds_count(emu_lib, op):
    """The WIDE_MAD products of one wide_mul, wide_sq and wide_pow22523
    equal the counts of chip_smoke.py's bound: WIDE_MUL's and WIDE_SQ's
    products less the one for 19 times the top carry (a 64-bit multiply,
    not a WIDE_MAD), and for the chain fe.pow22523's multiplies and
    squarings at those counts."""
    import chip_smoke

    mul, sq = chip_smoke.WIDE_MUL[0] - 1, chip_smoke.WIDE_SQ[0] - 1
    if op == "pow22523":
        n_mul, n_sq = chip_smoke._count_mul_sq(lambda: fe.pow22523(fe.from_ints([2])))
        want = n_mul * mul + n_sq * sq
    else:
        want = mul if op == "mul" else sq
    a = fe.from_ints([2])
    code = ["mul", "sq", "pow22523"].index(op)
    assert _wide_mads(emu_lib, lambda: _wide(emu_lib, code, a, a)) == want


@pytest.mark.parametrize("kernel", ["k1_rlc", "k1_decompress", "epoch_coords"])
def test_cold_k1_wide_products_equal_the_bounds_count(request, kernel):
    """The WIDE_MAD products of the whole k1_rlc at 1 lane (8 points),
    k1_decompress at 1 signature (2 points) and epoch_coords at 1 row (1
    point), over zero bytes, equal chip_smoke.wide_multiplies' count a
    point (itself held to the sources' headers) less the one a wide
    squaring or multiply forms for 19 times the top carry."""
    import chip_smoke

    wide = chip_smoke.wide_multiplies()
    want = wide["wide"] - wide["squarings"] - wide["multiplies"]
    if kernel == "k1_rlc":
        lib = request.getfixturevalue("emu_kernels")
        args = [torch.zeros((rlc.M * 32, 1), dtype=torch.uint8) for _ in range(2)]
        args.append(torch.zeros((rlc.N_SCAL * 32, 1), dtype=torch.uint8))
        outs = [torch.full((r, 1), -1, dtype=torch.int32)
                for r in (rlc.COORD_ROWS, 2 * rlc.M, rlc.DIG_ROWS)]
        points = chip_smoke.WIDE_POINTS_PER_UNIT["k1_rlc"]
    elif kernel == "epoch_coords":
        lib = request.getfixturevalue("emu_kernels")
        args = [torch.zeros((32, 1), dtype=torch.uint8)]
        outs = [torch.full((r, 1), -1, dtype=torch.int32) for r in (epoch_cache.TABLE_ROWS, 1)]
        points = chip_smoke.WIDE_POINTS_PER_UNIT["epoch_coords"]
    else:
        lib = request.getfixturevalue("emu_verify")
        args = [torch.zeros((32, 1), dtype=torch.uint8) for _ in range(4)]
        outs = [torch.full((r, 1), -1, dtype=torch.int32)
                for r in (verify.COORD_ROWS, 2, verify.DIG_ROWS, verify.DIG_ROWS)]
        points = chip_smoke.WIDE_POINTS_PER_UNIT["k1_decompress"]
    launch = getattr(lib, f"emu_{kernel}")
    ptrs = [t.data_ptr() for t in args + outs]
    rc = []
    assert _wide_mads(lib, lambda: rc.append(launch(*ptrs, 1))) == points * want
    assert rc == [0]


@pytest.mark.parametrize("lanes", [1, 3])
def test_k1_rlc_kernel_equals_plain(emu_kernels, lanes):
    """The whole k1_rlc kernel (decompressions on the wide field, inline)
    against k1_rlc_plain over the last 4 lanes - 1 entries of
    chip_smoke.py's ZIP-215 edge battery (at 3 lanes: a key off the
    curve, small-order and non-canonical keys, random bytes whose R do
    not decompress) and a padding slot: every output raw, rows 20..31 of
    each coordinate slot included, each output starting as -1. 1 and 3
    lanes leave most threads of the block past the end."""
    import chip_smoke

    ents = chip_smoke.edge_entries()[-(4 * lanes - 1):]
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in rlc.prepare_rlc(EntryBlock.from_entries(ents), 4 * lanes)][:3]
    want = rlc.k1_rlc_plain(*args)
    got = tuple(torch.full_like(w, -1) for w in want)
    assert emu_kernels.emu_k1_rlc(*(x.data_ptr() for x in args),
                                  *(g.data_ptr() for g in got), lanes) == 0
    _raw_equal(got, want)
    if lanes > 1:
        ok = want[1].flatten().tolist()
        assert 0 in ok and 1 in ok


def test_k1_decompress_kernel_equals_plain(emu_verify):
    """The whole k1_decompress kernel (decompressions on the wide field,
    inline)
    against k1_decompress_plain over chip_smoke.py's ZIP-215 edge battery
    (non-canonical y, small-order keys, the sqrt(-1) branch, keys and R
    that do not decompress) and 4 padding signatures: every output raw,
    rows 20..31 of each coordinate slot included, each output starting
    as -1."""
    import chip_smoke

    ents = chip_smoke.edge_entries()
    n = len(ents) + 4
    args = [torch.from_numpy(a).contiguous()
            for a in verify.prepare_compact(EntryBlock.from_entries(ents), n)][:4]
    want = verify.k1_decompress_plain(*args)
    got = tuple(torch.full_like(w, -1) for w in want)
    assert emu_verify.emu_k1_decompress(*(x.data_ptr() for x in args),
                                        *(g.data_ptr() for g in got), n) == 0
    _raw_equal(got, want)
    ok = want[1][:, : len(ents)].flatten().tolist()
    assert 0 in ok and 1 in ok


@pytest.mark.parametrize("rows", [1, 40])
def test_epoch_coords_kernel_equals_plain(emu_kernels, rows):
    """The whole epoch_coords kernel (one thread a row, the decompression
    inline on the wide field) against epoch_coords_plain over the keys of
    chip_smoke.py's ZIP-215 edge battery (non-canonical y, small-order
    keys, the sqrt(-1) branch, a y that does not decompress, random
    bytes), valid keys and 4 padding rows holding the identity encoding:
    every output raw, rows 20..31 of each slot included, each output
    starting as -1. At 1 row a non-canonical key; 40 rows run past one
    warp, and both leave threads of the block past the end."""
    import chip_smoke

    keys = [p for p, _, _ in chip_smoke.edge_entries()]
    if rows == 1:
        keys = [next(k for k in keys if int.from_bytes(k, "little") % (1 << 255) >= _edwards.P)]
    else:
        keys += [_edwards.pubkey_from_seed(bytes([i]) * 32) for i in range(rows - 4 - len(keys))]
        keys += [epoch_cache._IDENT_ENC.tobytes()] * 4
    pub_t = torch.from_numpy(np.frombuffer(b"".join(keys), np.uint8).reshape(rows, 32).T.copy())
    want = epoch_cache.epoch_coords_plain(pub_t)
    got = tuple(torch.full_like(w, -1) for w in want)
    assert emu_kernels.emu_epoch_coords(pub_t.data_ptr(), *(g.data_ptr() for g in got),
                                        rows) == 0
    _raw_equal(got, want)
    if rows > 1:
        ok = want[1].flatten().tolist()
        assert 0 in ok and 1 in ok and ok[-4:] == [1] * 4


# -- the wide quad point functions (csrc/ed25519_verify.cu's ladder) ------------

WIDE_P = _wide_split(fe.P)


def _wide_bounds() -> dict:
    """The limb maxima of fe25519.cuh's wide quad functions, by exact
    arithmetic on limb maxima over the formulas as its header states them:
    every subtrahend within its multiple of p, every operand within what
    wide_mul and wide_sq take (19 g and 2 f below 2^32), every column sum
    and every step of wide_carry below 2^64. M (the limbs of a coordinate
    or a table entry) is taken to its fixed point from limbs within their
    widths. Returns M, the largest left factor l of a round 2 and the
    largest column sum."""
    top = {"column": 0}

    def add(*xs):
        return [sum(c) for c in zip(*xs)]

    def sub(a, b, k):  # a + k p - b
        assert all(k * p >= y for p, y in zip(WIDE_P, b))
        return [x + k * p for x, p in zip(a, WIDE_P)]

    def fold(x):
        assert max(x) < 1 << 32
        c = [v >> b for v, b in zip(x, WIDE_BITS)]
        return [min(v, (1 << b) - 1) + (19 * c[9] if i == 0 else c[i - 1])
                for i, (v, b) in enumerate(zip(x, WIDE_BITS))]

    def mul(f, g):
        assert all(2 * x < 1 << 32 for x in f[1::2]) and all(19 * x < 1 << 32 for x in g)
        h = [0] * 10
        for i in range(10):
            for j in range(10):
                h[(i + j) % 10] += (f[i] * (2 if i & j & 1 else 1)
                                    * g[j] * (19 if i + j >= 10 else 1))
        top["column"] = max(top["column"], *h)
        for i in (0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0):  # wide_carry's order
            c, h[i] = h[i] >> WIDE_BITS[i], min(h[i], (1 << WIDE_BITS[i]) - 1)
            h[(i + 1) % 10] += 19 * c if i == 9 else c
            assert max(h) < 1 << 64
        return h

    def mx(*xs):
        return [max(c) for c in zip(*xs)]

    m, zero = [(1 << b) - 1 for b in WIDE_BITS], [0] * 10
    while True:
        # a double: round 1 squares X, X + Y, Z and Y (wide_sq's column sums
        # are mul's), round 2 E F, G H, F G, E H
        c = mx(mul(m, m), mul(add(m, m), add(m, m)))
        e, f = sub(c, add(c, c), 4), sub(c, add(c, c, c), 4)
        g, h = sub(c, c, 2), sub(zero, add(c, c), 4)
        l_dbl = mx(e, g, f)
        out = [mul(l_dbl, fold(mx(f, h, g)))]
        # a table entry (to_niels, folded), then a Niels add
        ent = fold(mx(add(m, m), sub(m, m, 2), m, mul(m, m)))
        c = mul(mx(sub(m, m, 2), add(m, m), m), ent)
        e, f = sub(c, c, 2), sub(add(c, c), c, 2)
        g, h = add(c, c, c), add(c, c)
        l_add = mx(e, g, f)
        out += [c, mul(l_add, fold(mx(f, h, g))), ent, fold(sub(zero, m, 2))]
        nxt = mx(m, *out)
        if nxt == m:
            return {"M": m, "l": mx(l_dbl, l_add), "column": top["column"]}
        m = nxt


def test_wide_quad_limb_bounds():
    """The bounds fe25519.cuh states for the wide quad functions: M, the
    left factors of round 2 (5 * 2^26 - 5), the column sums (below
    2^61.29) hold, and every operation stays in range (asserted inside)."""
    b = _wide_bounds()
    over = [2**26 + 56, 2**25 + 950] + [2**26 + 2, 2**25 + 2] * 4
    over[5] = 2**25 + 590
    assert b["M"] == over
    assert max(b["l"]) == 5 * 2**26 - 5
    assert b["column"] < 2**61.29


def _wide_fe(limbs) -> torch.Tensor:
    """(10, n) wide limbs of any size -> fe limbs of their values mod p."""
    return fe.from_ints([_wide_value(c) % fe.P for c in np.asarray(limbs).T])


def _wide_at_ends(rng, top, n: int) -> np.ndarray:
    """(10, n) uint32 limbs: column 0 every limb at top, column 1 all 0,
    column 2 top and 0 alternating, the rest seeded random up to top."""
    top = np.asarray(top, dtype=np.uint64)[:, None]
    w = (rng.random((10, n)) * (top + 1)).astype(np.uint64)
    w[:, 0] = top[:, 0]
    w[:, 1] = 0
    w[:, 2] = np.where(np.arange(10) % 2 == 0, top[:, 0], 0)
    return w.astype(np.uint32)


@pytest.mark.parametrize("op", ["mul", "sq", "fold"])
def test_wide_field_at_the_quad_bounds(emu_lib, op):
    """wide_mul, wide_sq and wide_fold on limbs at the ends the header
    states for the wide quad functions, written out by wide_out against
    ops/fe.py on the values: a round 2 product (l up to its bound, r in
    M), X + Y squared (2 M), and a fold of l into M."""
    b = _wide_bounds()
    rng = np.random.default_rng(68)
    if op == "mul":
        wa, wb = _wide_at_ends(rng, b["l"], 16), _wide_at_ends(rng, b["M"], 16)
        wb[:, 1] = b["M"]  # the largest l by the largest r
    else:
        wa = _wide_at_ends(rng, [2 * x for x in b["M"]] if op == "sq" else b["l"], 16)
        wb = wa
    a, c = _wide_fe(wa), _wide_fe(wb)
    got = _wide(emu_lib, {"mul": 0, "sq": 1, "fold": 4}[op], a, c, wa, wb)
    want = fe.mul(a, c) if op == "mul" else fe.sq(a) if op == "sq" else a
    assert torch.equal(got, fe.canon(want))


def _wquad_points(seed: int, top=None) -> np.ndarray:
    """(4, 10, 8) uint32: eight points' coordinates in M, at its ends."""
    rng = np.random.default_rng(seed)
    top = _wide_bounds()["M"] if top is None else top
    return np.stack([_wide_at_ends(rng, top, B) for _ in range(4)])


def _wquad_run(emu_lib, op: int, need_t: bool, pts, ents=None):
    ents = np.zeros_like(pts) if ents is None else ents
    out = torch.full((4, fe.NLIMBS, B), -1, dtype=torch.int32)
    pts, ents = np.ascontiguousarray(pts), np.ascontiguousarray(ents)
    assert emu_lib.emu_wquad(op, int(need_t), pts.ctypes.data, ents.ctypes.data,
                             out.data_ptr(), B) == 0
    return out


def _as_point(w):
    return tuple(_wide_fe(w[c]) for c in range(4))


def _canon_point(p):
    return torch.stack([fe.canon(c) for c in p])


@pytest.mark.parametrize("need_t", [True, False])
def test_wquad_double_equals_point_double(emu_lib, need_t):
    p = _wquad_points(71)
    want = _canon_point(point.point_double(_as_point(p), need_t=need_t))
    assert torch.equal(_wquad_run(emu_lib, 0, need_t, p), want)


@pytest.mark.parametrize("need_t", [True, False])
def test_wquad_add_niels_equals_point_add_niels(emu_lib, need_t):
    p, q = _wquad_points(72), _wquad_points(73)
    want = _canon_point(point.point_add_niels(_as_point(p), _as_point(q), need_t=need_t))
    assert torch.equal(_wquad_run(emu_lib, 1, need_t, p, q), want)


def test_wquad_add_equals_point_add(emu_lib):
    """wquad_add against point.point_add on unrelated points and with P
    = Q."""
    p, q = _wquad_points(74), _wquad_points(75)
    want = _canon_point(point.point_add(_as_point(p), _as_point(q)))
    assert torch.equal(_wquad_run(emu_lib, 3, True, p, q), want)
    want = _canon_point(point.point_add(_as_point(p), _as_point(p)))
    assert torch.equal(_wquad_run(emu_lib, 3, True, p, p), want)


def test_wquad_to_niels_equals_to_niels(emu_lib):
    p = _wquad_points(76)
    assert torch.equal(_wquad_run(emu_lib, 4, False, p), _canon_point(point.to_niels(_as_point(p))))


def test_wquad_cofactor_identity_equals_the_plain_test(emu_lib):
    """[8]P == O (X = 0, Y = Z after three doubles) against the same
    test on point.py's doubles: the identity and points of order 8 ([L]
    Q of curve points Q, by y = 3, 4, ...), each scaled by a factor
    lambda, in the even columns, and the points Q themselves and random
    limbs in the odd ones."""
    rng = np.random.default_rng(77)
    cols, y = [], 3
    for i in range(B // 2):
        q = None
        while i and q is None:
            q = _edwards.decompress(y.to_bytes(32, "little"))
            y += 1
            t8 = q and _edwards.scalar_mult(_edwards.L, q)
            if q and _edwards.is_identity(_edwards.scalar_mult(4, t8)):
                q = None  # not of order 8
        lam = int(rng.integers(1, 1 << 62))
        for pt in (t8 if i else _edwards.IDENTITY, q or _edwards.BASE):
            cols.append([c * lam % fe.P for c in pt])
    cols[-1] = [int(x) for x in rng.integers(0, 1 << 62, 4)]
    pts = np.array([[_wide_split(v) for v in c] for c in cols], dtype=np.uint32)
    pts = np.ascontiguousarray(pts.transpose(1, 2, 0))  # (4, 10, 8)
    a8 = _as_point(pts)
    for _ in range(3):
        a8 = point.point_double(a8, need_t=False)
    want = (fe.is_zero(a8[0]) & fe.is_zero(fe.sub(a8[1], a8[2])))[0].int()
    got = _wquad_run(emu_lib, 2, False, pts)[0, 0]
    assert got.tolist() == want.tolist() == [1, 0] * (B // 2)


def test_wide_decompress_equals_decompress(emu_lib):
    """wide_decompress (one thread, all on the wide field) against
    point.decompress on the keys and R of chip_smoke.py's ZIP-215 edge
    battery (non-canonical y, the sqrt(-1) branch, small-order keys,
    points that do not decompress, random bytes), the encodings of y = 1
    and y = -1 with the sign bit set ("negative zero"), and 2^255 - 1:
    the flag and x, y, t modulo p."""
    import chip_smoke

    rows = [p for p, _, _ in chip_smoke.edge_entries()]
    rows += [s[:32] for _, _, s in chip_smoke.edge_entries()]
    rows += [(1).to_bytes(32, "little")[:31] + b"\x80",
             (fe.P - 1).to_bytes(32, "little")[:31] + bytes([0x80 | 0x7F]), b"\xff" * 32]
    n = len(rows)
    raw = np.frombuffer(b"".join(rows), np.uint8).reshape(n, 32)
    out = torch.full((3, fe.NLIMBS, n), -1, dtype=torch.int32)
    ok = torch.full((n,), -1, dtype=torch.int32)
    emu_lib.emu_wide_decompress(np.ascontiguousarray(raw).ctypes.data, out.data_ptr(),
                                ok.data_ptr(), n)
    y, sign = point.unpack_limbs(torch.from_numpy(raw.T.astype(np.int32)))
    want_ok, (x, y, _, t) = point.decompress(y, sign)
    assert ok.tolist() == want_ok[0].int().tolist()
    assert 0 in ok.tolist() and 1 in ok.tolist()
    assert torch.equal(out, torch.stack([fe.canon(c) for c in (x, y, t)]))


@pytest.mark.parametrize("kernel", ["og_verify", "og_verify_cached"])
def test_og_wide_products_equal_the_count(emu_og, kernel):
    """The WIDE_MAD products of one whole og_verify (or og_verify_cached)
    signature, 16 signatures of one row, equal
    chip_smoke.og_kernel_products' count (less the product a wide
    squaring or multiply forms for 19 times the top carry), and exceed
    the count of chip_smoke.py's bound: the plain version's multiplies
    and squarings on the wide field."""
    import chip_smoke

    from tendermint_tpu_torch.ops import ed25519_verify as og

    count = chip_smoke.og_kernel_products()
    want = count["wide"] - 4 * (count["squarings"] + count["multiplies"])
    ents = _og_entries()[:1]
    rows = og.prepare_batch(EntryBlock.from_entries(ents), device_hash=False).args
    n_mul, n_sq = chip_smoke._count_mul_sq(
        lambda: og.og_verify_plain(*(torch.from_numpy(a[:1]) for a in rows)))
    args = [torch.from_numpy(np.repeat(a[:1], 16, axis=0)) for a in rows]
    assert n_mul * chip_smoke.PRODUCTS_MUL + n_sq * chip_smoke.PRODUCTS_SQ == (
        chip_smoke.PRODUCTS_PER_UNIT["og_verify"])
    assert want > n_mul * (chip_smoke.WIDE_MUL[0] - 1) + n_sq * (chip_smoke.WIDE_SQ[0] - 1)
    out = torch.full((16,), -1, dtype=torch.int32)
    if kernel == "og_verify":
        ptrs = [x.data_ptr() for x in args] + [out.data_ptr()]
        launch = lambda: emu_og.emu_og_verify(*ptrs, 16)  # noqa: E731
    else:
        block, ep = chip_smoke.with_epoch(EntryBlock.from_entries(ents), 9)
        ctbl, oktbl = epoch_cache.epoch_coords_plain(
            torch.from_numpy(np.ascontiguousarray(ep.pub_rows.T)))
        idx = torch.from_numpy(np.repeat(epoch_cache.table_columns(block, 1, ep), 16))
        ptrs = [x.data_ptr() for x in [ctbl, oktbl, idx] + args[1:]] + [out.data_ptr()]
        launch = lambda: emu_og.emu_og_verify_cached(*ptrs, 16, ep.vp)  # noqa: E731
    rc = []
    assert _wide_mads(emu_og, lambda: rc.append(launch())) == 16 * want
    assert rc == [0] and out.tolist() == [1] * 16


# -- the op-graph kernels (csrc/sha512.cu, csrc/ed25519_verify.cu) --------------

# R || A || M totals of 64 (one block), 111 and 112 (the length field's
# boundary: one block, then two), 127, 128, 239 (two), 240 and 256 (three)
OG_TOTALS = (64, 111, 112, 127, 128, 239, 240, 256)


def test_sha512_challenge_kernel_equals_plain(emu_og):
    """The whole sha512_challenge kernel against sha512_challenge_plain
    and against hashlib and Python's % L, every byte of k: rows of 1, 2
    and 3 blocks at the boundaries of the length field and 2 padding
    rows (the identity pattern), each output byte starting as 0xAA."""
    import hashlib

    from tendermint_tpu_torch.ops import sha512

    rng = np.random.default_rng(16)
    ents = [(rng.bytes(32), rng.bytes(t - 64), rng.bytes(64)) for t in OG_TOTALS]
    block = EntryBlock.from_entries(ents)
    n = len(ents) + 2
    hi, lo, counts = sha512.pad_ram_block(block, n, sha512.MAX_LEN)
    assert sorted(set(counts.tolist())) == [1, 2, 3]
    ins = [torch.from_numpy(sha512.as_int32(hi)), torch.from_numpy(sha512.as_int32(lo)),
           torch.from_numpy(counts)]
    want = sha512.sha512_challenge_plain(*ins)
    got = torch.full_like(want, 0xAA)
    assert emu_og.emu_sha512_challenge(*(x.data_ptr() for x in ins), got.data_ptr(), n,
                                       sha512.NBLOCK) == 0
    assert torch.equal(got, want)
    msgs = [s[:32] + p + m for p, m, s in ents] + [sha512._PAD_PAIR] * 2
    assert [bytes(r) for r in got.numpy()] == [
        (int.from_bytes(hashlib.sha512(m).digest(), "little") % _edwards.L).to_bytes(32, "little")
        for m in msgs]


def _og_entries():
    """chip_smoke.py's edge battery cut to ten rows: two valid, a
    tampered signature, a wrong message, a corrupted key, s >= L, a key
    off the curve, a small-order key, a non-canonical key, random bytes."""
    import chip_smoke

    ents = chip_smoke.edge_entries()
    return [ents[i] for i in (0, 1, 6, 7, 8, 9, 10, 11, 14, len(ents) - 1)]


def test_og_verify_kernel_equals_plain(emu_og):
    """The whole og_verify kernel (a quad a signature: both
    decompressions, the table in shared memory, the ladder, - R, [8], the
    identity test) against og_verify_plain and the ZIP-215 oracle, on the
    host challenges of _og_entries and 2 padding rows: 12 signatures, so
    quads of the block run past the end."""
    from tendermint_tpu_torch.ops import ed25519_verify as og

    ents = _og_entries()
    batch = og.prepare_batch(EntryBlock.from_entries(ents), device_hash=False)
    n = len(ents) + 2
    ins = [torch.from_numpy(a[:n]).contiguous() for a in batch.args]
    want = og.og_verify_plain(*ins)
    assert want.tolist() == [int(_edwards.verify_zip215(*e)) for e in ents] + [1, 1]
    got = torch.full_like(want, -1)
    assert emu_og.emu_og_verify(*(x.data_ptr() for x in ins), got.data_ptr(), n) == 0
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def emu_tally(tmp_path_factory):
    lib = _kernel_lib(tmp_path_factory, "tally_emu", ("tally",), TALLY_HARNESS)
    lib.emu_commit_tally.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    return lib


@pytest.mark.parametrize("rows,m", [(1, 1), (300, 1), (600, 4), (2048, 4)])
def test_commit_tally_kernel_equals_plain(emu_tally, rows, m):
    """The whole commit_tally kernel (a thread a row, the warp's shuffle
    sums of each word's halves, a 64-bit atomicAdd a warp) against
    commit_tally_plain, every word: live padding rows, verdicts of 0, 1
    and 2, powers up to 2^60 - 1 and, beyond split_power's range, int32
    lanes of any sign; an all-invalid shard; blocks past the last row."""
    from tendermint_tpu_torch.ops import sharded

    rng = np.random.default_rng(rows * 10 + m)
    valid = rng.integers(0, 3, rows // m).astype(np.int32)
    live = np.ones(rows, np.int32)
    live[rows - rows // 5 :] = 0
    powers = rng.integers(0, 1 << 60, rows)
    powers[0] = (1 << 60) - 1
    lanes = sharded.split_power(powers)
    wild = rng.integers(-(1 << 31), 1 << 31, (rows, 4)).astype(np.int32)
    for v, pw in ((valid, lanes), (np.zeros_like(valid), lanes), (valid, wild)):
        ins = [torch.from_numpy(np.ascontiguousarray(x)) for x in (v, live, pw)]
        want = sharded.commit_tally_plain(*ins, m)
        got = torch.zeros(5, dtype=torch.int64)
        assert emu_tally.emu_commit_tally(*(x.data_ptr() for x in ins), got.data_ptr(), rows,
                                          m) == 0
        assert torch.equal(got, want)


def test_og_verify_cached_kernel_equals_plain(emu_og):
    """The whole og_verify_cached kernel against og_verify_cached_plain
    and the oracle: _og_entries' keys in a shuffled epoch table (the
    corrupted and off-curve keys do not decompress), 2 padding rows on
    column vp - 1."""
    import chip_smoke

    from tendermint_tpu_torch.ops import ed25519_verify as og

    ents = _og_entries()
    block, ep = chip_smoke.with_epoch(EntryBlock.from_entries(ents), 9)
    n = len(ents) + 2
    idx = epoch_cache.table_columns(block, n, ep)
    _, r_rows, s_rows, k_rows, s_ok = og.prepare_batch(
        EntryBlock.from_entries(ents), device_hash=False).args
    ctbl, oktbl = epoch_cache.epoch_coords_plain(
        torch.from_numpy(np.ascontiguousarray(ep.pub_rows.T)))
    assert 0 in oktbl[0].tolist()
    ins = [ctbl, oktbl] + [torch.from_numpy(a[:n]).contiguous()
                           for a in (idx, r_rows, s_rows, k_rows, s_ok)]
    want = og.og_verify_cached_plain(*ins)
    assert want.tolist() == [int(_edwards.verify_zip215(*e)) for e in ents] + [1, 1]
    got = torch.full_like(want, -1)
    assert emu_og.emu_og_verify_cached(*(x.data_ptr() for x in ins), got.data_ptr(), n,
                                       ep.vp) == 0
    assert torch.equal(got, want)
