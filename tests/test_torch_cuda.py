"""The CUDA kernels of the port against their plain PyTorch versions, on
the card. These tests need an NVIDIA card and nvcc (marker `cuda`); where
torch sees no CUDA device they skip, decided inside the `cuda` fixture.
Run them on the card with `python -m pytest tests/test_torch_cuda.py`.

Tolerance: none. Coordinates are compared after canonicalisation (and
are expected equal limb for limb), flags, digits and verdicts exactly;
the quad k2_rlc's and k2_table's tables and the outputs of the four K1s
(k1_rlc, k1_decompress and their cached forms), of the epoch table build
and of k1r_decode raw, every row of every slot.
"""

import hashlib

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import _edwards
from tendermint_tpu_torch.crypto import ed25519
from tendermint_tpu_torch.crypto import sr25519
from tendermint_tpu_torch.ops import epoch_cache, fe, kernels, rlc, verify
from tendermint_tpu_torch.ops import sr25519 as osr
from tendermint_tpu_torch.ops.entry_block import EntryBlock

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("torch sees no CUDA device")
    return torch.device("cuda", 0)


def _entries(n: int) -> list:
    out = []
    for i in range(n):
        sk = ed25519.gen_priv_key(hashlib.sha256(b"cuda %d" % i).digest())
        msg = b"cuda-test-%d" % i
        out.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    # a tampered signature, a small-order key, s >= L
    pk, msg, sig = out[5]
    out[5] = (pk, msg, sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:])
    s = 12345
    r = _edwards.compress(_edwards.scalar_mult(s, _edwards.BASE))
    out[9] = (bytes(32), b"small order", r + s.to_bytes(32, "little"))
    out[13] = (out[13][0], out[13][1], out[13][2][:32] + (_edwards.L + 1).to_bytes(32, "little"))
    return out


@pytest.fixture(scope="module")
def inputs(cuda):
    """64 lanes: 240 signatures and 4 padding lanes, on the card."""
    args = rlc.prepare_rlc(EntryBlock.from_entries(_entries(240)), 256)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in args]


def _canon_slots(x):
    slots, g = x.shape[0] // 32, x.shape[1]
    limbs = x.view(slots, 32, g)[:, : fe.NLIMBS].permute(1, 0, 2).reshape(fe.NLIMBS, -1)
    return fe.canon(limbs)


def test_k1_matches_plain(inputs):
    a_t, r_t, scal_t, _ = inputs
    want = rlc.k1_rlc_plain(a_t, r_t, scal_t)
    got = rlc.k1_rlc(a_t, r_t, scal_t)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k2_and_k3_match_plain(inputs):
    a_t, r_t, scal_t, sok = inputs
    coords, ok, dig = rlc.k1_rlc_plain(a_t, r_t, scal_t)
    tbl_p = rlc.k2_rlc_plain(coords)
    tbl_k = rlc.k2_rlc(coords)
    torch.cuda.synchronize()
    assert torch.equal(_canon_slots(tbl_k), _canon_slots(tbl_p))
    out_p = rlc.k3_rlc_plain(tbl_p, dig, coords, ok, sok)
    out_k = rlc.k3_rlc(tbl_p, dig, coords, ok, sok)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    lanes = out_k.cpu().numpy()[0].astype(bool)
    assert lanes.tolist() == [i not in (1, 3) for i in range(64)]  # tampered, s >= L


def test_verify_batch_launches_each_kernel_once(cuda):
    block = EntryBlock.from_entries(_entries(100))
    kernels.reset_launches()
    got = rlc.verify_batch_rlc(block, device=cuda)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "k1_rlc": 1, "k2_rlc": 1, "k3_rlc": 1}
    assert got.tolist() == [_edwards.verify_zip215(*e) for e in block.iter_entries()]


def test_cuda_wrappers_reject_mixed_devices(inputs):
    a_t, r_t, scal_t, _ = inputs
    with pytest.raises(ValueError, match="expected"):
        rlc.k1_rlc(a_t, r_t.cpu(), scal_t)


@pytest.fixture(scope="module")
def epoch(cuda):
    """An epoch of the 240 keys of _entries(240), in a shuffled order."""
    ents = _entries(240)
    pubs = [p for p, _, _ in ents]
    order = np.random.default_rng(3).permutation(240)
    col = np.frombuffer(b"".join(pubs[i] for i in order), np.uint8).reshape(240, 32)
    val_idx = np.argsort(order).astype(np.int32)
    ep = epoch_cache.EpochEntry(b"E" * 32, col)
    return ents, ep, val_idx


def test_k1_rlc_cached_matches_plain(epoch, cuda):
    ents, ep, val_idx = epoch
    block = EntryBlock.from_entries(ents)
    block = EntryBlock(block.pub, block.sig, block.msgs, block.offsets, val_idx=val_idx,
                       epoch_key=ep.key)
    args = [torch.from_numpy(a).to(cuda) for a in rlc.prepare_rlc_cached(block, 256, ep)[:3]]
    tables = ep.coords_tables(cuda)
    want = rlc.k1_rlc_cached_plain(*tables, *args)
    got = rlc.k1_rlc_cached(*tables, *args)
    torch.cuda.synchronize()
    assert torch.equal(_canon_slots(got[0]), _canon_slots(want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_per_signature_kernels_match_plain(cuda):
    ents = _entries(250)
    args = [torch.from_numpy(a).to(cuda)
            for a in verify.prepare_compact(EntryBlock.from_entries(ents), 256)]
    want = verify.k1_decompress_plain(*args[:4])
    got = verify.k1_decompress(*args[:4])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    tbl_p = verify.k2_table_plain(want[0])
    tbl_k = verify.k2_table(want[0])
    torch.cuda.synchronize()
    assert torch.equal(_canon_slots(tbl_k), _canon_slots(tbl_p))
    out_p = verify.k3_ladder_plain(tbl_p, want[2], want[3], want[0], want[1], args[4])
    out_k = verify.k3_ladder(tbl_p, want[2], want[3], want[0], want[1], args[4])
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    oracle = [_edwards.verify_zip215(*e) for e in ents] + [True] * 6
    assert out_k.cpu().numpy()[0].astype(bool).tolist() == oracle


def test_warm_verify_batch_launches_the_cached_k1(epoch, cuda):
    ents, ep, val_idx = epoch
    epoch_cache.reset(depth=8)
    try:
        cache = epoch_cache.cache()
        cache.note(ep.key, ep.pub_rows[: ep.n_vals])
        block = EntryBlock.from_entries(ents)
        block = EntryBlock(block.pub, block.sig, block.msgs, block.offsets,
                           val_idx=val_idx, epoch_key=ep.key)
        kernels.reset_launches()
        got = rlc.verify_batch_rlc(block, device=cuda)
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
            "epoch_coords": 1, "k1_rlc_cached": 1, "k2_rlc": 1, "k3_rlc": 1}
        assert got.tolist() == [_edwards.verify_zip215(*e) for e in ents]
    finally:
        epoch_cache.reset()


def _warm_block(ents, ep, val_idx):
    block = EntryBlock.from_entries(ents)
    return EntryBlock(block.pub, block.sig, block.msgs, block.offsets,
                      val_idx=val_idx, epoch_key=ep.key)


def test_k1_decompress_cached_matches_plain(epoch, cuda):
    ents, ep, val_idx = epoch
    args = verify.prepare_compact_cached(_warm_block(ents, ep, val_idx), 256, ep)
    args = [torch.from_numpy(a).to(cuda) for a in args[:4]]
    tables = ep.coords_tables(cuda)
    want = verify.k1_decompress_cached_plain(*tables, *args)
    got = verify.k1_decompress_cached(*tables, *args)
    torch.cuda.synchronize()
    assert torch.equal(_canon_slots(got[0]), _canon_slots(want[0]))
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))


def test_warm_per_signature_batch_launches_the_cached_k1(epoch, cuda, monkeypatch):
    ents, ep, val_idx = epoch
    epoch_cache.reset(depth=8)
    try:
        epoch_cache.cache().note(ep.key, ep.pub_rows[: ep.n_vals])
        kernels.reset_launches()
        got = verify.verify_batch_compact(_warm_block(ents, ep, val_idx), device=cuda)
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
            "epoch_coords": 1, "k1_decompress_cached": 1, "k2_table": 1, "k3_ladder": 1}
        assert got.tolist() == [_edwards.verify_zip215(*e) for e in ents]
    finally:
        epoch_cache.reset()


def _sr_entries(n: int) -> list:
    """n sr25519 signatures; #3 tampered, #7 without the v1 marker, #11
    under the all-zero key (the identity: accepted for any message when
    R = [s]B), #12 under an odd key encoding, #13 with R = p + 1."""
    out = []
    for i in range(n):
        sk = sr25519.gen_priv_key(hashlib.sha256(b"cuda sr %d" % i).digest())
        msg = b"cuda-sr-%d" % i
        out.append((sk.pub_key().bytes(), msg, sk.sign(msg)))
    pk, msg, sig = out[3]
    out[3] = (pk, msg, sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:])
    pk, msg, sig = out[7]
    out[7] = (pk, msg, sig[:63] + bytes([sig[63] & 0x7F]))
    s = 4242
    r = sr25519.R.encode(sr25519.R.scalar_mult(s, sr25519.R.BASE))
    out[11] = (bytes(32), b"identity key", r + (s | 1 << 255).to_bytes(32, "little"))
    out[12] = ((1).to_bytes(32, "little"), out[12][1], out[12][2])
    out[13] = (out[13][0], out[13][1], (_edwards.P + 1).to_bytes(32, "little") + out[13][2][32:])
    return out


def test_sr25519_kernels_match_plain(cuda):
    ents = _sr_entries(40)
    args = [torch.from_numpy(a).to(cuda)
            for a in osr.prepare_sr25519(EntryBlock.from_entries(ents), 256)]
    want = osr.k1r_decode_plain(*args[:6])
    got = osr.k1r_decode(*args[:6])
    torch.cuda.synchronize()
    assert torch.equal(_canon_slots(got[0]), _canon_slots(want[0]))
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    tbl = verify.k2_table_plain(want[0])
    out_p = osr.k3r_ladder_plain(tbl, want[2], want[3], want[0], want[1], args[6])
    out_k = osr.k3r_ladder(tbl, want[2], want[3], want[0], want[1], args[6])
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    oracle = [sr25519.verify(*e) for e in ents] + [True] * 216
    assert out_k.cpu().numpy()[0].astype(bool).tolist() == oracle
    assert [i for i in range(40) if not oracle[i]] == [3, 7, 12, 13] and oracle[11]


def test_sr25519_batch_launches_each_kernel_once(cuda):
    ents = _sr_entries(20)
    kernels.reset_launches()
    got = osr.verify_batch_sr25519(EntryBlock.from_entries(ents), device=cuda)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "k1r_decode": 1, "k2_table": 1, "k3r_ladder": 1}
    assert got.tolist() == [sr25519.verify(*e) for e in ents]


# -- the quad ladders (k3_rlc, k3_ladder) over rejecting rows and padding --------


@pytest.fixture(scope="module")
def battery():
    """(entries, oracle verdicts): chip_smoke.py's ZIP-215 edge battery
    (corrupted and tampered signatures, s >= L, small-order and
    non-canonical keys, a key off the curve, random bytes) and 140
    distinct valid signatures."""
    import chip_smoke

    ents = chip_smoke.edge_entries() + _entries(160)[20:]
    return ents, [_edwards.verify_zip215(*e) for e in ents]


def _spread(battery, n: int, seed: int) -> tuple:
    """n entries drawn from the battery, every battery entry first when n
    allows, in a seeded order: (EntryBlock, oracle verdicts)."""
    ents, oracle = battery
    rng = np.random.default_rng(seed)
    pick = np.concatenate([rng.permutation(len(ents)),
                           rng.integers(0, len(ents), max(0, n - len(ents)))])[:n]
    pick = pick[rng.permutation(n)]
    return EntryBlock.from_entries([ents[i] for i in pick]), np.array(oracle)[pick]


@pytest.mark.parametrize("lanes", [1, 2, 64, 2560])
def test_k3_rlc_matches_plain_over_rejects_and_padding(battery, cuda, lanes):
    """The quad k3_rlc against k3_rlc_plain: every lane's verdict equal.
    The last live lane holds one signature and three padding slots, and
    at 64 and 2,560 lanes the last 8 lanes are all padding; 1 and 2 lanes
    do not fill a block of the kernel."""
    n = 1 if lanes == 1 else 4 * lanes - (35 if lanes >= 64 else 3)
    block, oracle = _spread(battery, n, lanes)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in rlc.prepare_rlc(block, 4 * lanes)]
    coords, ok, dig = rlc.k1_rlc_plain(*args[:3])
    tbl = rlc.k2_rlc_plain(coords)
    want = rlc.k3_rlc_plain(tbl, dig, coords, ok, args[3])
    got = rlc.k3_rlc(tbl, dig, coords, ok, args[3])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    per_sig = np.ones(4 * lanes, dtype=bool)
    per_sig[:n] = oracle
    assert got.cpu().numpy()[0].astype(bool).tolist() == per_sig.reshape(lanes, 4).all(1).tolist()
    if lanes >= 64:
        assert 0 < int(got.sum()) < lanes


@pytest.mark.parametrize("n", [250, 256, 10240])
def test_k3_ladder_matches_plain_over_rejects_and_padding(battery, cuda, n):
    """The quad k3_ladder against k3_ladder_plain: every verdict equal,
    with 6 padding signatures; 250 signatures do not fill a block of the
    kernel."""
    block, oracle = _spread(battery, n - 6, n)
    args = [torch.from_numpy(a).to(cuda) for a in verify.prepare_compact(block, n)]
    coords, ok, sdig, kdig = verify.k1_decompress_plain(*args[:4])
    tbl = verify.k2_table_plain(coords)
    want = verify.k3_ladder_plain(tbl, sdig, kdig, coords, ok, args[4])
    got = verify.k3_ladder(tbl, sdig, kdig, coords, ok, args[4])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.cpu().numpy()[0].astype(bool).tolist() == oracle.tolist() + [True] * 6
    assert 0 < int(got.sum()) < n


# -- the quad k2_rlc and k3r_ladder ------------------------------------------------


def _garbage_pool(dev, *shapes) -> None:
    """Leave blocks of the caching allocator that torch.empty of `shapes`,
    in that order, will reuse filled with -1, so a row the kernel never
    writes shows. The blocks are held together, then freed."""
    bufs = [torch.full(s, -1, dtype=torch.int32, device=dev) for s in shapes]
    torch.cuda.synchronize()
    del bufs


@pytest.mark.parametrize("lanes", [1, 2, 64, 2560])
def test_k2_rlc_matches_plain_on_every_row(battery, cuda, lanes):
    """The quad k2_rlc against k2_rlc_plain: every raw limb of every slot,
    rows 20..31 of each included (k2_rlc allocates its output with
    torch.empty). The coordinates come from the ZIP-215 battery through
    k1_rlc_plain, padding slots and lanes included; 1 and 2 lanes do not
    fill a block of the kernel."""
    n = 1 if lanes == 1 else 4 * lanes - (35 if lanes >= 64 else 3)
    block, _ = _spread(battery, n, lanes + 1)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in rlc.prepare_rlc(block, 4 * lanes)]
    coords = rlc.k1_rlc_plain(*args[:3])[0]
    want = rlc.k2_rlc_plain(coords)
    _garbage_pool(cuda, want.shape)
    got = rlc.k2_rlc(coords)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def sr_battery():
    """(entries, oracle verdicts): chip_smoke.py's ristretto edge battery
    (tampered s, wrong message, no marker, s >= L, keys and R that do not
    decode, the identity key, random bytes) and 60 distinct signatures of
    _sr_entries, which hold their own tampered and rejecting rows."""
    import chip_smoke

    ents = chip_smoke.sr_edge_entries() + _sr_entries(60)
    return ents, [sr25519.verify(*e) for e in ents]


@pytest.mark.parametrize("n", [1, 250, 256, 10240])
def test_k3r_ladder_matches_plain_over_rejects_and_padding(sr_battery, cuda, n):
    """The quad k3r_ladder against k3r_ladder_plain: every verdict equal,
    with 6 padding signatures (the all-zero identity, every flag 1) where
    n > 1; 1 and 250 signatures do not fill a block of the kernel."""
    live = 1 if n == 1 else n - 6
    block, oracle = _spread(sr_battery, live, n)
    args = [torch.from_numpy(a).to(cuda) for a in osr.prepare_sr25519(block, n)]
    coords, ok, sdig, kdig = osr.k1r_decode_plain(*args[:6])
    tbl = verify.k2_table_plain(coords)
    want = osr.k3r_ladder_plain(tbl, sdig, kdig, coords, ok, args[6])
    got = osr.k3r_ladder(tbl, sdig, kdig, coords, ok, args[6])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.cpu().numpy()[0].astype(bool).tolist() == oracle.tolist() + [True] * (n - live)
    if n > 1:
        assert 0 < int(got.sum()) < n


# -- the quad k2_table and the split-product k1_decompress_cached --------------


@pytest.mark.parametrize("n", [1, 250, 10240])
def test_k2_table_matches_plain_on_every_row(battery, cuda, n):
    """The quad k2_table against k2_table_plain: every raw limb of every
    slot, rows 20..31 included (k2_table allocates with torch.empty). The
    coordinates come from the ZIP-215 battery through k1_decompress_plain,
    with 6 padding signatures where n > 1; 1 and 250 signatures do not
    fill a block of the kernel."""
    live = 1 if n == 1 else n - 6
    block, _ = _spread(battery, live, n + 2)
    args = [torch.from_numpy(a).to(cuda) for a in verify.prepare_compact(block, n)]
    coords = verify.k1_decompress_plain(*args[:4])[0]
    want = verify.k2_table_plain(coords)
    _garbage_pool(cuda, want.shape)
    got = verify.k2_table(coords)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 250, 10240])
def test_k1_decompress_cached_matches_plain_on_raw_limbs(battery, cuda, n):
    """The split-product k1_decompress_cached against its plain version
    on raw limbs: A's and R's coordinate slots (rows 20..31 included),
    both flags and the digits of s and k, with every output allocated on
    -1-filled memory. Over the ZIP-215 battery (non-canonical y, the
    sqrt(-1) branch, encodings that do not decompress) in an epoch whose
    table columns are out of order, with 6 padding signatures on column
    vp - 1 where n > 1; 1 and 250 signatures leave quads of the last
    block past the end."""
    import chip_smoke

    live = 1 if n == 1 else n - 6
    block, _ = _spread(battery, live, n + 3)
    wblock, ep = chip_smoke.with_epoch(block, n)
    args = [torch.from_numpy(a).to(cuda) for a in verify.prepare_compact_cached(wblock, n, ep)]
    tables = ep.coords_tables(cuda)
    want = verify.k1_decompress_cached_plain(*tables, *args[:4])
    _garbage_pool(cuda, *(w.shape for w in want))
    got = verify.k1_decompress_cached(*tables, *args[:4])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if n > 1:
        assert 0 < int(want[1].sum()) < 2 * n


# -- the warm RLC K1 and K1r on raw limbs ---------------------------------------


@pytest.mark.parametrize("lanes", [1, 2, 64, 2560])
def test_k1_rlc_cached_matches_plain_on_raw_limbs(battery, cuda, lanes):
    """The split-product k1_rlc_cached against its plain version on raw
    limbs: the coordinate slots of A and R (rows 20..31 included), the 2M
    flags and the digits of the 2M scalars, with every output allocated
    on -1-filled memory. Over the ZIP-215 battery in an epoch whose table
    columns are out of order; the last live lane holds one signature and
    three padding slots on column vp - 1, and at 64 and 2,560 lanes the
    last 8 lanes are all padding; 1 and 2 lanes leave quads of each block
    past the end."""
    import chip_smoke

    n = 1 if lanes == 1 else 4 * lanes - (35 if lanes >= 64 else 3)
    block, _ = _spread(battery, n, lanes + 5)
    wblock, ep = chip_smoke.with_epoch(block, lanes)
    args = [torch.from_numpy(a).to(cuda) for a in rlc.prepare_rlc_cached(wblock, 4 * lanes, ep)]
    tables = ep.coords_tables(cuda)
    want = rlc.k1_rlc_cached_plain(*tables, *args[:3])
    _garbage_pool(cuda, *(w.shape for w in want))
    got = rlc.k1_rlc_cached(*tables, *args[:3])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if lanes >= 64:
        assert 0 < int(want[1][rlc.M :].sum()) < rlc.M * lanes


@pytest.mark.parametrize("n", [1, 250, 10240])
def test_k1r_decode_matches_plain_on_raw_limbs(sr_battery, cuda, n):
    """k1r_decode against k1r_decode_plain on raw limbs: the coordinate
    slots of A and R (rows 20..31 included), both flags and the digits of
    s and k, with every output allocated on -1-filled memory. Over the
    ristretto battery with 6 padding signatures (the all-zero identity,
    every flag 1) where n > 1; 1 and 250 signatures leave threads of the
    last block past the end."""
    live = 1 if n == 1 else n - 6
    block, _ = _spread(sr_battery, live, n + 7)
    args = [torch.from_numpy(a).to(cuda) for a in osr.prepare_sr25519(block, n)][:6]
    want = osr.k1r_decode_plain(*args)
    _garbage_pool(cuda, *(w.shape for w in want))
    got = osr.k1r_decode(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if n > 1:
        assert 0 < int(want[1].sum()) < 2 * n


# -- the cold K1s on the wide field ---------------------------------------------


@pytest.mark.parametrize("lanes", [1, 2, 2560])
def test_k1_rlc_matches_plain_on_raw_limbs(battery, cuda, lanes):
    """k1_rlc (A_j and R_j of a lane in one thread, on the wide field)
    against k1_rlc_plain on raw limbs: the coordinate slots of A and R
    (rows 20..31 included), the 2M flags and the digits of the 2M
    scalars, with every output allocated on -1-filled memory. Over the
    ZIP-215 battery; the last live lane holds one signature and three
    padding slots, and at 2,560 lanes the last 8 lanes are all padding;
    1 and 2 lanes leave threads of the block past the end."""
    n = 1 if lanes == 1 else 4 * lanes - (35 if lanes >= 64 else 3)
    block, _ = _spread(battery, n, lanes + 9)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in rlc.prepare_rlc(block, 4 * lanes)][:3]
    want = rlc.k1_rlc_plain(*args)
    _garbage_pool(cuda, *(w.shape for w in want))
    got = rlc.k1_rlc(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if lanes > 2:
        assert 0 < int(want[1].sum()) < 2 * rlc.M * lanes


@pytest.mark.parametrize("n", [1, 250, 10240])
def test_k1_decompress_matches_plain_on_raw_limbs(battery, cuda, n):
    """k1_decompress (A and R of a signature in one thread, on the wide
    field) against k1_decompress_plain on raw limbs: A's and R's
    coordinate slots (rows 20..31 included), both flags and the digits of
    s and k, with every output allocated on -1-filled memory. Over the
    ZIP-215 battery (non-canonical y, the sqrt(-1) branch, encodings that
    do not decompress) with 6 padding signatures where n > 1; 1 and 250
    signatures leave threads of the last block past the end."""
    live = 1 if n == 1 else n - 6
    block, _ = _spread(battery, live, n + 11)
    args = [torch.from_numpy(a).to(cuda) for a in verify.prepare_compact(block, n)][:4]
    want = verify.k1_decompress_plain(*args)
    _garbage_pool(cuda, *(w.shape for w in want))
    got = verify.k1_decompress(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if n > 1:
        assert 0 < int(want[1].sum()) < 2 * n


@pytest.mark.parametrize("rows", [1, 250, 16384])
def test_epoch_coords_matches_plain(battery, cuda, rows):
    """epoch_coords (one thread a row, the decompression inline on the
    wide field) against epoch_coords_plain on raw limbs: the coordinate
    slots (rows 20..31 included) and the flags, with both outputs
    allocated on -1-filled memory. Over the keys of the ZIP-215 battery
    (non-canonical y, small-order keys, the sqrt(-1) branch, a y that
    does not decompress) with 6 padding rows holding the identity
    encoding where rows > 1; 1 and 250 rows leave threads of the last
    block past the end."""
    live = 1 if rows == 1 else rows - 6
    block, _ = _spread(battery, live, rows + 17)
    pub = np.empty((rows, 32), dtype=np.uint8)
    pub[:live] = block.pub
    pub[live:] = epoch_cache._IDENT_ENC
    pub_t = torch.from_numpy(np.ascontiguousarray(pub.T)).to(cuda)
    want = epoch_cache.epoch_coords_plain(pub_t)
    _garbage_pool(cuda, *(w.shape for w in want))
    got = epoch_cache.epoch_coords(pub_t)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if rows > 1:
        assert 0 < int(want[1].sum()) < rows and bool(want[1][0, live:].all())


@pytest.mark.parametrize("rows", [1, 16, 200])
def test_secp_kernels_match_plain(cuda, rows):
    """secp_verify and secp_verify_cached against their plain versions:
    verdicts and the canonical final (X, Y, Z), outputs allocated on
    -1-filled memory. Over chip_smoke.py's secp256k1 edge battery and the
    two crafted rows where only the r + n candidate matches (padding
    where rows > 15); 1 and 200 rows leave threads of the last block past
    the end. The cached kernel reads a table of the battery's keys in
    reverse order."""
    import chip_smoke
    from tendermint_tpu_torch.ops import secp_verify as sv

    edge = chip_smoke.secp_edge_entries()
    items = (edge * (rows // len(edge) + 1))[: max(rows - 2, 1)]
    args = list(sv.prepare_rows(items, rows))
    if rows > 2:
        for a, w in zip(args, chip_smoke.secp_wrap_rows()):
            a[rows - 2 :] = w
    t = [torch.from_numpy(a).to(cuda) for a in args]
    want = sv.verify_plain(*t, want_xyz=True)
    _garbage_pool(cuda, (rows, 3, sv.NW))
    got = sv.secp_verify(*t, want_xyz=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    pubs = sorted({p for p, _, _ in edge})[::-1]
    tbl = [torch.from_numpy(a).to(cuda) for a in sv.table_columns(pubs)]
    vidx = np.array([pubs.index(p) for p, _, _ in items], dtype=np.int32)
    ct = [torch.from_numpy(a).to(cuda)
          for a in sv.prepare_rows_cached(items, vidx, rows, len(pubs), len(pubs))]
    want = sv.verify_cached_plain(*tbl, *ct, want_xyz=True)
    got = sv.secp_verify_cached(*tbl, *ct, want_xyz=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if rows > 2:
        assert 0 < int(want[0].sum()) < rows


@pytest.mark.parametrize("k,n,rows", [(4, 8, 4), (16, 20, 8)])
def test_bls_kernels_match_plain(cuda, k, n, rows):
    """bls_miller and bls_finalexp (fused and by rows) against their plain
    versions, word for word, over the first `rows` commits of
    chip_smoke.py's BLS battery on a committee of n keys (pad commits
    past them at K = 16), outputs allocated on -1-filled memory; the
    codes they give equal the battery's."""
    import chip_smoke
    from tendermint_tpu_torch.ops import bls_verify as bv

    pubs = chip_smoke.bls_battery_committee(n)
    items, want = chip_smoke.bls_battery(n, b"cuda bls battery")
    items, want = items[:rows], want[:rows]
    tables = [torch.from_numpy(a).to(cuda) for a in bv.table_columns_g1(pubs)]
    bad = bv.bad_rows(np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(n, 48))
    got = []
    for c in range(0, len(items), k):
        chunk = items[c : c + k]
        masks, coeffs, ok, reasons = bv.prepare_commits(chunk, k, n + 1, bad)
        t = tables + [torch.from_numpy(masks).to(cuda), torch.from_numpy(coeffs).to(cuda)]
        want_apk, want_f = bv.verify_plain(*t)
        _garbage_pool(cuda, (k, 3, bv.NW), (k, 6, 2, bv.NW))
        apk, f = bv.bls_miller(*t)
        torch.cuda.synchronize()
        assert torch.equal(apk, want_apk) and torch.equal(f, want_f)
        res = bv.bls_finalexp(f)
        fused = bv.bls_finalexp(f, fused=True)
        torch.cuda.synchronize()
        assert torch.equal(res, bv.finalexp_plain(f))
        assert torch.equal(fused, bv.finalexp_plain(f, fused=True))
        codes, _ = chip_smoke.bls_codes(apk.cpu().numpy(), res.cpu().numpy(),
                                        fused[0].cpu().numpy(), ok, reasons)
        got.extend(codes[: len(chunk)].tolist())
    assert got == want


def test_bls_finalexp_edge_rows_match_plain(cuda):
    """bls_finalexp by rows and fused on f = 0 (the norm's inversion maps 0
    to 0, so the residue is 0), f = 1 and seeded random rows, word for word
    against finalexp_plain."""
    import chip_smoke
    from tendermint_tpu_torch.ops import bls_verify as bv

    rows = torch.from_numpy(chip_smoke.bls_finalexp_rows(6, seed=7)).to(cuda)
    res = bv.bls_finalexp(rows)
    fused = bv.bls_finalexp(rows[1:], fused=True)
    torch.cuda.synchronize()
    assert torch.equal(res, bv.finalexp_plain(rows))
    assert torch.equal(fused, bv.finalexp_plain(rows[1:], fused=True))
    assert not res[0].any() and bv.residue_is_one(res[1].cpu().numpy())


# -- the op-graph path: sha512_challenge, og_verify, og_verify_cached ----------------


@pytest.mark.parametrize("n", [1, 130, 10240])
def test_sha512_challenge_matches_plain(cuda, n):
    """sha512_challenge against sha512_challenge_plain and Python's
    SHA-512 mod L, every byte, on R || A || M of every length from 64 to
    256 bytes (1, 2 and 3 blocks) and 2 padding rows where n > 1, the
    output on 0xAA-filled memory."""
    from tendermint_tpu_torch.ops import sha512

    rng = np.random.default_rng(n)
    live = 1 if n == 1 else n - 2
    ents = [(rng.bytes(32), rng.bytes(int(m)), rng.bytes(64))
            for m in rng.integers(0, 193, live)]
    ents[0] = (ents[0][0], rng.bytes(192), ents[0][2])
    hi, lo, counts = sha512.pad_ram_block(EntryBlock.from_entries(ents), n, sha512.MAX_LEN)
    args = [torch.from_numpy(sha512.as_int32(hi)).to(cuda),
            torch.from_numpy(sha512.as_int32(lo)).to(cuda), torch.from_numpy(counts).to(cuda)]
    want = sha512.sha512_challenge_plain(*args)
    bufs = torch.full((n, 32), 0xAA, dtype=torch.uint8, device=cuda)
    del bufs
    got = sha512.sha512_challenge(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for i in range(0, live, max(1, live // 64)):
        p, m, s = ents[i]
        k = int.from_bytes(hashlib.sha512(s[:32] + p + m).digest(), "little") % _edwards.L
        assert bytes(got[i].cpu().numpy()) == k.to_bytes(32, "little")


@pytest.mark.parametrize("n", [1, 250, 10240])
@pytest.mark.parametrize("cached", [False, True])
def test_og_verify_matches_plain_over_rejects_and_padding(battery, cuda, n, cached):
    """og_verify (and og_verify_cached, over an epoch whose table columns
    are out of order) against its plain version and the oracle, every
    verdict, with the challenges hashed on the card; 6 padding signatures
    where n > 1; 1 and 250 signatures leave quads of the last block past
    the end."""
    import chip_smoke

    from tendermint_tpu_torch.ops import ed25519_verify as og
    from tendermint_tpu_torch.ops import sha512

    live = 1 if n == 1 else n - 6
    block, oracle = _spread(battery, live, n + 11)
    batch = og.prepare_batch(block, device_hash=True)
    a, r, s, hi, lo, counts, sok = (torch.from_numpy(x[:n].copy()).to(cuda) for x in batch.args)
    k = sha512.sha512_challenge(hi, lo, counts)
    if cached:
        wblock, ep = chip_smoke.with_epoch(block, n)
        idx = torch.from_numpy(epoch_cache.table_columns(wblock, n, ep)).to(cuda)
        ins = (*ep.coords_tables(cuda), idx, r, s, k, sok)
        want = og.og_verify_cached_plain(*ins)
        got = og.og_verify_cached(*ins)
    else:
        want = og.og_verify_plain(a, r, s, k, sok)
        got = og.og_verify(a, r, s, k, sok)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.cpu().numpy()[:live].astype(bool).tolist() == oracle.tolist()
    assert bool(got[live:].all())


@pytest.mark.parametrize("host_hash", ["0", "1"])
def test_verify_batch_og_on_the_card(battery, cuda, monkeypatch, host_hash):
    """verify_batch_og over 10,300 signatures (two chunks, the second in
    the 128 bucket) equals the oracle, each route launching its kernels
    once a chunk: sha512_challenge only on the device-hash route."""
    from tendermint_tpu_torch.ops import ed25519_verify as og

    monkeypatch.setenv("TM_TPU_HOST_HASH", host_hash)
    block, oracle = _spread(battery, 10300, 77)
    before = dict(kernels.LAUNCHES)
    got = og.verify_batch_og(block, device=cuda)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert got.tolist() == oracle.tolist()
    want = {"og_verify": 2}
    if host_hash == "0":
        want["sha512_challenge"] = 2
    assert launched == want


def test_pool_slots_never_take_memory_the_compute_stream_still_uses(cuda):
    """A slot's device tensors are made on the copy stream: a block the
    compute stream freed while its work is pending (the batch before's
    verdicts, freed once their readback is queued) is not handed to a
    slot whose copy-stream writes would land under that work. Made on
    the compute stream, the slot took exactly that block, and slice (g4)
    of chip_smoke.py read another batch's input bytes as verdicts in
    about one run in five."""
    from tendermint_tpu_torch.ops import device_pool

    compute, copy = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    args = [np.arange(4096, dtype=np.int32)]
    with torch.cuda.stream(compute):
        pending = torch.empty((4096,), dtype=torch.int32, device=cuda)
        torch.cuda._sleep(50_000_000)  # the compute stream's work still runs
        pending.fill_(7)
        ptr = pending.data_ptr()
        del pending
        pool = device_pool.DeviceBufferPool(2, cuda)
        slot = pool.acquire(device_pool.layout_key(1, args), args, copy)
        assert all(d.data_ptr() != ptr for d in slot.dev)
        got = device_pool.transfer(slot, args, copy, compute)[0]
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.from_numpy(args[0]))


@pytest.mark.parametrize("rows,m", [(1, 1), (10240, 1), (10240, 4), (333, 1)])
def test_commit_tally_matches_plain(cuda, rows, m):
    """commit_tally against commit_tally_plain, every word: verdicts with
    zeros and values other than 1, padding rows not live, powers at the
    top of the range (2^60 - 1); an all-invalid shard too."""
    from tendermint_tpu_torch.ops import sharded

    rng = np.random.default_rng(rows + m)
    valid = rng.integers(0, 3, rows // m).astype(np.int32)
    live = np.ones(rows, np.int32)
    live[rows - rows // 7 :] = 0
    powers = rng.integers(0, 1 << 60, rows)
    powers[0] = (1 << 60) - 1
    for v in (valid, np.zeros_like(valid)):
        ins = [torch.from_numpy(x).to(cuda) for x in (v, live, sharded.split_power(powers))]
        before = kernels.LAUNCHES["commit_tally"]
        got = sharded.commit_tally(*ins, m)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["commit_tally"] == before + 1
        assert torch.equal(got, sharded.commit_tally_plain(*ins, m))


def test_verify_commit_sharded_two_shards_on_one_card(battery, cuda):
    """verify_commit_sharded on Mesh((cuda:0, cuda:0)) (two shards run one
    after another on the card) equals the oracle and the host tally: one
    og_verify and one commit_tally a shard."""
    from tendermint_tpu_torch.ops import sharded

    block, oracle = _spread(battery, 300, 5)
    powers = [int(p) for p in np.random.default_rng(5).integers(1, 1 << 50, len(block))]
    before = dict(kernels.LAUNCHES)
    valid, tallied, all_valid = sharded.verify_commit_sharded(
        block, powers, sharded.Mesh([cuda, cuda]))
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert valid.tolist() == oracle.tolist()
    assert tallied == sum(p for p, ok in zip(powers, oracle) if ok)
    assert all_valid is bool(oracle.all())
    assert launched == {"og_verify": 2, "commit_tally": 2}
