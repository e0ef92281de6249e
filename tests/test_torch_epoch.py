"""The port's warm validator-set epoch (tendermint_tpu_torch/ops/
epoch_cache.py, the cached K1 of ops/rlc.py) on the CPU against the JAX
package's (tendermint_tpu/ops/epoch_cache.py, pallas_rlc.py).

- The table: the plain version of epoch_coords equals the JAX
  epoch_cache._coords_fn() over keys that decompress, keys that do not,
  small-order and non-canonical keys, and identity padding rows.
- prepare_rlc_cached: byte-equal to the JAX function for the same
  coefficients. K1 cached: the plain version equals the JAX kernel body
  run eagerly (tests/pallas_bodies.py) limb for limb, at 8 lanes with a
  distinct key in every slot, table rows out of order, padding
  signatures and a padding lane; the warm lane verdicts equal the cold.
- The per-signature warm path (ops/verify.py): prepare_compact_cached
  byte-equal to the JAX one; the plain k1_decompress_cached equals the
  JAX _k1_decompress_kernel_cached body at 32 signatures (a distinct key
  in every row, table rows out of order, padding); its verdicts equal
  the cold K1's and the oracle's.
- ValidatorSet.hash() and ed25519_columns() equal the JAX set's.
- The LRU: hit, miss and eviction counts, order, the disabled cache, the
  EntryBlock metadata through slices and concat, and the fallback of an
  evicted or unknown epoch to the cold path (tests/test_epoch_cache.py).
- verify_commit, cold then warm: the same outcome and blame string as
  the JAX package, the first call through k1_rlc, the second through
  k1_rlc_cached; with TM_TPU_RLC=0 through k1_decompress, then
  k1_decompress_cached.

Tolerance: none; every compared value is an integer or a flag.
"""

import os

os.environ.setdefault("TM_TPU_PUREPY_CRYPTO", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pallas_bodies import run_body  # noqa: E402
from test_ops import _edge_entries  # noqa: E402
from test_torch_commit import CHAIN_ID, _both, _make, _outcome, _tampered  # noqa: E402
from tendermint_tpu.crypto import _edwards as E  # noqa: E402
from tendermint_tpu.crypto import batch as jbatch  # noqa: E402
from tendermint_tpu.crypto import ed25519 as jed  # noqa: E402
from tendermint_tpu.ops import epoch_cache as jepoch  # noqa: E402
from tendermint_tpu.ops import pallas_rlc  # noqa: E402
from tendermint_tpu.ops import pallas_verify as pv  # noqa: E402
from tendermint_tpu.ops.entry_block import EntryBlock as JEntryBlock  # noqa: E402
from tendermint_tpu.types.validator_set import Validator as JValidator  # noqa: E402
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet  # noqa: E402
from tendermint_tpu_torch import convert  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ped  # noqa: E402
from tendermint_tpu_torch.ops import epoch_cache, rlc, verify  # noqa: E402
from tendermint_tpu_torch.ops.entry_block import EntryBlock  # noqa: E402
from tendermint_tpu_torch.types import validation  # noqa: E402
from tendermint_tpu_torch.types.block import BlockID  # noqa: E402
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet  # noqa: E402

# The plain versions run thousands of small tensor ops: one intra-op
# thread keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

RLC_SEED = "20261016"
M = rlc.M


@pytest.fixture(autouse=True)
def _fresh_cache():
    epoch_cache.reset(depth=4)
    yield
    epoch_cache.reset()


def _signed(n: int, tag: int) -> list:
    rng = np.random.default_rng(tag)
    out = []
    for i in range(n):
        sk = jed.gen_priv_key(rng.bytes(32))
        msg = b"epoch-%d-%d" % (tag, i)
        out.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    return out


@pytest.fixture(scope="module")
def warm():
    """26 signatures, each under its own key: the edge battery without
    the two entries that repeat a key, 7 signed ones and one under a key
    that does not decompress. The validator column holds their keys and
    14 more, shuffled, so val_idx is out of order. Returns (entries, pub
    column, val_idx, JAX epoch entry, JAX table coords and flags)."""
    e = _edge_entries()
    bad = next(y.to_bytes(32, "little") for y in range(2, 100)
               if E.decompress(y.to_bytes(32, "little")) is None)
    entries = ([x for i, x in enumerate(e) if i not in (7, 9)] + _signed(7, 3)
               + [(bad, b"no such point", bytes(64))])
    pubs = [p for p, _, _ in entries] + [p for p, _, _ in _signed(14, 4)]
    assert len(set(pubs)) == len(pubs) == 40
    order = np.random.default_rng(5).permutation(len(pubs))
    col = np.frombuffer(b"".join(pubs[i] for i in order), dtype=np.uint8).reshape(-1, 32)
    val_idx = np.argsort(order)[: len(entries)].astype(np.int32)
    assert (col[val_idx] == np.frombuffer(b"".join(p for p, _, _ in entries),
                                          np.uint8).reshape(-1, 32)).all()
    jep = jepoch.EpochEntry(b"K" * 32, col)
    ctbl, oktbl = (np.asarray(a) for a in jepoch._coords_fn()(np.ascontiguousarray(jep.pub_rows.T)))
    return entries, col, val_idx, jep, ctbl, oktbl


def _blocks(entries, val_idx, key=b"K" * 32):
    pub = np.frombuffer(b"".join(p for p, _, _ in entries), np.uint8).reshape(-1, 32)
    port = EntryBlock.from_entries(entries)
    port = EntryBlock(port.pub, port.sig, port.msgs, port.offsets, val_idx=val_idx, epoch_key=key)
    jax = JEntryBlock(pub, port.sig, port.msgs, port.offsets, val_idx=val_idx, epoch_key=key)
    return port, jax


def _z(live: int, bucket: int) -> np.ndarray:
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_TPU_RLC_SEED", RLC_SEED)
        z = np.zeros((bucket, 32), dtype=np.uint8)
        z[:live] = pallas_rlc._gen_z(live)
    return z


def test_epoch_table_matches_jax_coords_fn(warm):
    _, col, _, jep, ctbl, oktbl = warm
    ep = epoch_cache.EpochEntry(b"K" * 32, col)
    assert (ep.n_vals, ep.vp) == (jep.n_vals, jep.vp) == (40, 64)
    np.testing.assert_array_equal(ep.pub_rows, jep.pub_rows)
    coords, ok = ep.coords_tables("cpu")
    np.testing.assert_array_equal(coords.numpy(), ctbl)
    np.testing.assert_array_equal(ok.numpy(), oktbl)
    assert not oktbl.all() and oktbl[0, 40:].all()  # bad keys; identity padding
    assert ep.coords_tables("cpu")[0] is coords  # built once per device


@pytest.mark.parametrize("n", [26, 0])
def test_prepare_rlc_cached_byte_equal_to_jax(warm, n):
    entries, col, val_idx, jep, _, _ = warm
    port, jax = _blocks(entries[:n], val_idx[:n])
    live = ((n + M - 1) // M) * M
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_TPU_RLC_SEED", RLC_SEED)
        want = pallas_rlc.prepare_rlc_cached(jax, 32, jep)
    got = rlc.prepare_rlc_cached(port, 32, epoch_cache.EpochEntry(b"K" * 32, col), z=_z(live, 32))
    assert len(got) == len(want) == 4
    for j, p in zip(want, got):
        assert j.dtype == p.dtype and j.shape == p.shape
        np.testing.assert_array_equal(j, p)
    assert (got[0][n:] == jep.vp - 1).all()


def test_k1_rlc_cached_matches_jax_body_and_the_cold_lanes(warm):
    """8 lanes: 26 signatures, two padding signatures in lane 6 and a
    padding lane. The JAX body gets its inputs as the JAX cached pipeline
    builds them (pallas_rlc.py:483-495)."""
    entries, col, val_idx, jep, ctbl, oktbl = warm
    port, _ = _blocks(entries, val_idx)
    z = _z(28, 32)
    ep = epoch_cache.EpochEntry(b"K" * 32, col)
    idx, r_rows, scal_rows, sok_rows = rlc.prepare_rlc_cached(port, 32, ep, z=z)
    g = 8
    ac = ctbl[:, idx].reshape(4 * 32, g, M).transpose(2, 0, 1).reshape(M * 4 * 32, g)
    aok = oktbl[:, idx].reshape(g, M).T
    r_t = r_rows.reshape(g, M, 32).transpose(1, 2, 0).reshape(M * 32, g)
    scal_t = scal_rows.transpose(1, 2, 0).reshape(rlc.N_SCAL * 32, g)
    want = run_body(pallas_rlc._k1_rlc_kernel_cached, [ac, aok, r_t, scal_t],
                    [rlc.COORD_ROWS, 2 * M, rlc.DIG_ROWS])
    tables = ep.coords_tables("cpu")
    args = [torch.from_numpy(a) for a in (idx, r_rows, scal_rows)]
    got = rlc.k1_rlc_cached(*tables, *args)
    for name, gv, w in zip(("coords", "ok", "dig"), got, want):
        np.testing.assert_array_equal(gv.numpy(), w, err_msg=name)
    # the warm lanes equal the cold path's on the same coefficients
    warm_lanes = rlc.k3_rlc(rlc.k2_rlc(got[0]), got[2], got[0], got[1],
                            torch.from_numpy(np.ascontiguousarray(sok_rows.T)))
    cold = [torch.from_numpy(a) for a in rlc.prepare_rlc(port, 32, z=z)]
    coords, ok, dig = rlc.k1_rlc(*cold[:3])
    cold_lanes = rlc.k3_rlc(rlc.k2_rlc(coords), dig, coords, ok, cold[3])
    assert torch.equal(warm_lanes, cold_lanes)
    oracle = [E.verify_zip215(*x) for x in entries] + [True] * 6
    assert warm_lanes.numpy()[0].astype(bool).tolist() == np.reshape(oracle, (g, M)).all(1).tolist()


@pytest.mark.parametrize("n", [26, 0])
def test_prepare_compact_cached_byte_equal_to_jax(warm, n):
    entries, col, val_idx, jep, _, _ = warm
    port, jax = _blocks(entries[:n], val_idx[:n])
    want = pv.prepare_compact_cached(jax, 32, jep)
    got = verify.prepare_compact_cached(port, 32, epoch_cache.EpochEntry(b"K" * 32, col))
    assert len(got) == len(want) == 5
    for j, p in zip(want, got):
        assert j.dtype == p.dtype and j.shape == p.shape
        np.testing.assert_array_equal(j, p)
    assert (got[0][n:] == jep.vp - 1).all()


def test_k1_decompress_cached_matches_jax_body_and_the_cold_k1(warm):
    """32 signatures: the 26 under distinct keys and 6 padding. The JAX
    body gets its inputs as the JAX cached pipeline builds them
    (pallas_verify.py:506-511)."""
    entries, col, val_idx, _, ctbl, oktbl = warm
    port, _ = _blocks(entries, val_idx)
    ep = epoch_cache.EpochEntry(b"K" * 32, col)
    idx, r_rows, s_rows, k_rows, sok = verify.prepare_compact_cached(port, 32, ep)
    want = run_body(pv._k1_decompress_kernel_cached,
                    [ctbl[:, idx], oktbl[:, idx], r_rows.T, s_rows.T, k_rows.T],
                    [verify.COORD_ROWS, 2, verify.DIG_ROWS, verify.DIG_ROWS])
    got = verify.k1_decompress_cached(*ep.coords_tables("cpu"),
                                      *(torch.from_numpy(a) for a in (idx, r_rows, s_rows, k_rows)))
    for name, gv, w in zip(("coords", "ok", "sdig", "kdig"), got, want):
        np.testing.assert_array_equal(gv.numpy(), w, err_msg=name)
    # the same verdicts as the cold K1 on the same signatures
    cold = [torch.from_numpy(a) for a in verify.prepare_compact(port, 32)]
    c_coords, c_ok, c_sdig, c_kdig = verify.k1_decompress(*cold[:4])
    sok = torch.from_numpy(sok)
    warm_out = verify.k3_ladder(verify.k2_table(got[0]), got[2], got[3], got[0], got[1], sok)
    cold_out = verify.k3_ladder(verify.k2_table(c_coords), c_sdig, c_kdig, c_coords, c_ok, sok)
    assert torch.equal(warm_out, cold_out)
    oracle = [E.verify_zip215(*x) for x in entries] + [True] * 6
    assert warm_out.numpy()[0].astype(bool).tolist() == oracle


def test_val_idx_outside_the_set_is_refused(warm):
    entries, col, val_idx, _, _, _ = warm
    port, _ = _blocks(entries[:4], np.array([0, 1, 2, 40], dtype=np.int32))
    with pytest.raises(ValueError, match="outside"):
        rlc.prepare_rlc_cached(port, 4, epoch_cache.EpochEntry(b"K" * 32, col))


def test_validator_set_hash_and_columns_match_jax():
    rng = np.random.default_rng(6)
    sks = [jed.gen_priv_key(rng.bytes(32)) for _ in range(20)]
    jset = JValidatorSet.new([JValidator.new(sk.pub_key(), int(p))
                              for sk, p in zip(sks, rng.integers(1, 1000, 20))])
    pset = ValidatorSet.decode(jset.encode())
    assert pset.hash() == jset.hash()
    assert [v.bytes() for v in pset.validators] == [v.bytes() for v in jset.validators]
    for p, j in zip(pset.ed25519_columns(), jset.ed25519_columns()):
        np.testing.assert_array_equal(p, j)
    assert ValidatorSet().hash() == JValidatorSet().hash()


# -- the LRU --------------------------------------------------------------------


def _set(n: int, tag: int) -> ValidatorSet:
    rng = np.random.default_rng(100 + tag)
    return ValidatorSet.new([Validator.new(ped.PubKey(rng.bytes(32)), 10) for _ in range(n)])


def test_cold_then_warm():
    vs = _set(6, 0)
    assert epoch_cache.note_valset(vs) is None  # first sight: registers only
    assert epoch_cache.note_valset(vs) == vs.hash()
    ep = epoch_cache.cache().get(vs.hash())
    assert (ep.n_vals, ep.vp) == (6, 16)
    assert epoch_cache.stats() == {"enabled": True, "depth": 4, "entries": 1,
                                   "hits": 1, "misses": 1, "evictions": 0}


def test_hit_miss_evict_counts_and_order():
    sets = [_set(4 + i, i) for i in range(5)]
    for vs in sets:
        assert epoch_cache.note_valset(vs) is None
    s = epoch_cache.stats()
    assert (s["misses"], s["evictions"], s["entries"]) == (5, 1, 4)
    assert epoch_cache.note_valset(sets[4]) is not None
    assert epoch_cache.note_valset(sets[0]) is None  # evicted: cold again
    # sets[1] was the least recent and is gone; sets[2] touched stays
    assert epoch_cache.note_valset(sets[2]) is not None
    epoch_cache.note_valset(_set(12, 9))  # evicts sets[3]
    assert epoch_cache.note_valset(sets[2]) is not None
    assert epoch_cache.note_valset(sets[3]) is None
    s = epoch_cache.stats()
    assert (s["hits"], s["misses"], s["evictions"]) == (3, 8, 4)


@pytest.mark.parametrize("env, depth", [("0", 0), ("3", 3), ("-2", 0), ("x", 0), (None, 8)])
def test_depth_from_the_environment(env, depth, monkeypatch):
    if env is None:
        monkeypatch.delenv("TM_TPU_EPOCH_CACHE", raising=False)
    else:
        monkeypatch.setenv("TM_TPU_EPOCH_CACHE", env)
    epoch_cache.reset()
    assert epoch_cache.stats()["depth"] == depth
    vs = _set(3, 1)
    epoch_cache.note_valset(vs)
    assert (epoch_cache.note_valset(vs) is not None) == (depth > 0)
    assert (epoch_cache.cache() is None) == (depth == 0)


def test_a_set_with_a_key_of_another_type_is_never_warm():
    class OtherKey:
        def bytes(self):
            return bytes(32)

    vs = _set(3, 2)
    vs.validators[1].pub_key = OtherKey()
    assert vs.ed25519_columns() is None
    epoch_cache.note_valset(vs)
    assert epoch_cache.note_valset(vs) is None


def _meta_block(n, key, base=0):
    pub = np.arange(n * 32, dtype=np.uint8).reshape(n, 32)
    return EntryBlock(pub, np.zeros((n, 64), np.uint8), b"abc" * n,
                      np.arange(n + 1, dtype=np.int64) * 3,
                      val_idx=np.arange(base, base + n, dtype=np.int32), epoch_key=key)


def test_entry_block_metadata_through_slices_and_concat():
    k, other = b"K" * 32, b"L" * 32
    s = _meta_block(6, k)[2:5]
    assert s.epoch_key == k and s.val_idx.tolist() == [2, 3, 4]
    c = EntryBlock.concat([_meta_block(3, k), _meta_block(2, k, base=7)])
    assert c.epoch_key == k and c.val_idx.tolist() == [0, 1, 2, 7, 8]
    for b in (_meta_block(2, other), _meta_block(2, None)):
        c = EntryBlock.concat([_meta_block(3, k), b])
        assert c.epoch_key is None and c.val_idx is None
    with pytest.raises(ValueError, match="val_idx"):
        EntryBlock(np.zeros((2, 32), np.uint8), np.zeros((2, 64), np.uint8), b"",
                   np.zeros(3, np.int64), val_idx=np.zeros(3, np.int32))


K1S = {"rlc": ("k1_rlc", "k1_rlc_cached"), "per_sig": ("k1_decompress", "k1_decompress_cached")}


def _spy(monkeypatch, path="rlc"):
    calls = []
    mod = rlc if path == "rlc" else verify
    for name in K1S[path]:
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    return calls


def _evicted_or_unknown_goes_cold(warm, path, monkeypatch):
    entries, col, _, _, _, _ = warm
    entries = entries[-8:]  # 7 signed and one key off the curve: 2 lanes
    batch_fn = rlc.verify_batch_rlc if path == "rlc" else verify.verify_batch_compact
    cold_k1, warm_k1 = K1S[path]
    vs = ValidatorSet.new([Validator.new(ped.PubKey(p.tobytes()), 10) for p in col])
    rows = np.array([next(i for i, v in enumerate(vs.validators) if v.pub_key.bytes() == p)
                     for p, _, _ in entries], dtype=np.int32)
    epoch_cache.note_valset(vs)
    key = epoch_cache.note_valset(vs)
    assert key == vs.hash()
    calls = _spy(monkeypatch, path)
    oracle = [E.verify_zip215(*x) for x in entries]
    block, _ = _blocks(entries, rows, key)
    assert batch_fn(block, device="cpu").tolist() == oracle
    assert calls == [warm_k1]
    for i in range(4):  # evict
        epoch_cache.note_valset(_set(3, 20 + i))
    assert epoch_cache.cache().get(key) is None
    unknown, _ = _blocks(entries, rows, b"U" * 32)
    for b in (block, unknown):
        calls.clear()
        assert batch_fn(b, device="cpu").tolist() == oracle
        assert calls == [cold_k1]


def test_an_evicted_or_unknown_epoch_verifies_cold(warm, monkeypatch):
    """A block keyed to a set the cache dropped, or never saw, takes the
    cold K1 and gives the oracle's verdicts (epoch_cache.py:447-463)."""
    _evicted_or_unknown_goes_cold(warm, "rlc", monkeypatch)


def test_an_evicted_or_unknown_epoch_verifies_cold_per_signature(warm, monkeypatch):
    """The same on the per-signature path, at an 8-signature block
    (verify.BLOCK)."""
    monkeypatch.setattr(verify, "BLOCK", 8)
    _evicted_or_unknown_goes_cold(warm, "per_sig", monkeypatch)


# -- verify_commit, cold then warm ------------------------------------------------


@pytest.fixture(scope="module")
def commit64():
    return _make(64, 23)


@pytest.mark.parametrize("case", ["valid", "tampered"])
@pytest.mark.parametrize("mode", ["verify_commit", "verify_commit_light"])
def test_commit_cold_then_warm_matches_jax(case, mode, commit64, monkeypatch):
    """Two calls on one set: the first registers it, the second is warm.
    The light walk stops at 2/3, below the device threshold at this size,
    so it verifies on the host both times; it still notes the set."""
    monkeypatch.setattr(jbatch, "_device_verifier_factory", None)
    monkeypatch.delenv("TM_TPU_RLC", raising=False)
    vset, bid, commit = commit64
    if case == "tampered":
        commit = _tampered(commit, 5)
    epoch_cache.reset(depth=8)
    calls = _spy(monkeypatch)
    want, cold = _both(mode, vset, bid, commit.height, commit)
    pvals, pcommit = convert.state_from_wire(vset.encode(), commit.encode())
    fn = getattr(validation, mode)
    warm = _outcome(lambda: fn(CHAIN_ID, pvals, BlockID.decode(bid.encode()),
                               commit.height, pcommit, device="cpu"))
    assert cold == want and warm == want
    got = [cold, warm]
    assert calls == (["k1_rlc", "k1_rlc_cached"] if mode == "verify_commit" else [])
    s = epoch_cache.stats()
    assert (s["misses"], s["hits"]) == (1, 1)
    assert got[0] == got[1]
    if case == "valid":
        assert got[0] is None
    else:
        assert got[0][1].startswith("wrong signature (#5): ")


@pytest.mark.parametrize("case", ["valid", "tampered"])
def test_commit_per_signature_cold_then_warm_matches_jax(case, commit64, monkeypatch):
    """TM_TPU_RLC=0: the first call on a set runs k1_decompress, the
    second k1_decompress_cached, with the JAX package's outcome both
    times. The batches run at a 64-signature block (verify.BLOCK)."""
    monkeypatch.setattr(jbatch, "_device_verifier_factory", None)
    monkeypatch.setenv("TM_TPU_RLC", "0")
    monkeypatch.setattr(verify, "BLOCK", 64)
    vset, bid, commit = commit64
    if case == "tampered":
        commit = _tampered(commit, 41)
    epoch_cache.reset(depth=8)
    calls = _spy(monkeypatch, "per_sig")
    want, cold = _both("verify_commit", vset, bid, commit.height, commit)
    pvals, pcommit = convert.state_from_wire(vset.encode(), commit.encode())
    warm = _outcome(lambda: validation.verify_commit(
        CHAIN_ID, pvals, BlockID.decode(bid.encode()), commit.height, pcommit, device="cpu"))
    assert cold == want and warm == want
    assert calls == ["k1_decompress", "k1_decompress_cached"]
    assert want is None if case == "valid" else want[1].startswith("wrong signature (#41): ")
