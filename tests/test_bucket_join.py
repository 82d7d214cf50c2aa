"""Unit coverage for the bucketized device hash table (mesh.DeviceIndex +
mesh.hash_bucket_join) and the two-stage minimizer selection
(mesh.select_minimizers) — the round-5 step primitives. E2E parity is
covered by the golden suites; these pin the edge semantics directly:
bucket-chain spill, wrap-around at the table end, misses, and the
selection overflow flag at its exact boundary."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ntlink_jax.parallel.mesh import (  # noqa: E402
    BUCKET,
    SELECT_BLOCK,
    SELECT_CAP,
    DeviceIndex,
    hash_bucket_join,
    select_minimizers,
)


def _mkindex(hashes):
    n = len(hashes)
    return DeviceIndex(
        np.asarray(hashes, np.uint64),
        np.arange(n, dtype=np.int32) % 7,
        (np.arange(n, dtype=np.int32) * 13) % 1009,
        (np.arange(n) % 2).astype(bool),
    )


def _join(didx, hashes):
    q_hi = jnp.asarray((hashes >> np.uint64(32)).astype(np.uint32))
    q_lo = jnp.asarray((hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    f, c, p, s = hash_bucket_join(
        didx.t_bkt, q_hi, q_lo, didx.mask, didx.max_probes
    )
    return (np.asarray(f), np.asarray(c), np.asarray(p),
            np.asarray(s))


def test_all_entries_found_and_misses_miss():
    rng = np.random.default_rng(3)
    hashes = rng.integers(1, 2**63, 5000, dtype=np.uint64)
    hashes = np.unique(hashes)
    didx = _mkindex(hashes)
    f, c, p, s = _join(didx, hashes)
    assert f.all()
    n = len(hashes)
    assert (c == np.arange(n) % 7).all()
    assert (p == (np.arange(n) * 13) % 1009).all()
    assert (s == (np.arange(n) % 2).astype(bool)).all()
    # misses: perturb the low word
    miss = hashes ^ np.uint64(0x5A5A5A5A)
    miss = miss[~np.isin(miss, hashes)]
    f2, *_ = _join(didx, miss)
    assert not f2.any()


def test_bucket_spill_chains_stay_findable():
    """Force every entry into ONE home bucket: the spill chain must grow
    max_probes and every entry must still resolve, including entries
    whose chain wraps past the end of the table."""
    from ntlink_jax.parallel.mesh import _FIB

    rng = np.random.default_rng(4)
    # craft hashes whose (lo ^ hi) * FIB & mask all hit the LAST bucket
    # of the eventual table so the spill chain wraps to bucket 0
    pool = rng.integers(1, 2**63, 400_000, dtype=np.uint64)
    n_target = 3 * BUCKET  # needs a 3-bucket chain
    # table size for n_target entries (small tables build at avg fill 2)
    from ntlink_jax.parallel.mesh import BUCKET_LOAD_SMALL

    nb = 2
    while nb * BUCKET_LOAD_SMALL < n_target:
        nb <<= 1
    bmask = nb - 1
    lo = (pool & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (pool >> np.uint64(32)).astype(np.uint32)
    home = ((lo ^ hi) * np.uint32(_FIB)).astype(np.uint32) & np.uint32(bmask)
    picked = pool[home == bmask][:n_target]
    assert len(picked) == n_target, "increase pool"
    didx = _mkindex(np.unique(picked))
    assert didx.max_probes >= 3
    f, c, p, s = _join(didx, np.unique(picked))
    assert f.all()


def test_select_overflow_boundary():
    """Exactly SELECT_CAP emits in one block: fine. SELECT_CAP+1: the row
    is flagged (and only that row)."""
    B = 2
    NW = 16 * SELECT_BLOCK  # enough blocks that two-stage is active
    emit = np.zeros((B, NW), bool)
    emit[0, :SELECT_CAP] = True                    # exactly at cap
    emit[1, : SELECT_CAP + 1] = True               # one over
    sel, ok, overflow = select_minimizers(jnp.asarray(emit), 32)
    sel, ok, overflow = np.asarray(sel), np.asarray(ok), np.asarray(overflow)
    assert not overflow[0] and overflow[1]
    assert ok[0].sum() == SELECT_CAP
    assert (np.sort(sel[0][ok[0]]) == np.arange(SELECT_CAP)).all()
    # order preservation: selected indices ascend (read order)
    assert (np.diff(sel[0][ok[0]]) > 0).all()


def test_select_matches_argsort_reference():
    rng = np.random.default_rng(5)
    B, NW, S = 16, 2048, 64
    emit = rng.random((B, NW)) < 0.02
    sel, ok, overflow = select_minimizers(jnp.asarray(emit), S)
    sel, ok = np.asarray(sel), np.asarray(ok)
    assert not np.asarray(overflow).any()
    for b in range(B):
        want = np.nonzero(emit[b])[0][:S]
        got = sel[b][ok[b]]
        assert np.array_equal(got, want), b
