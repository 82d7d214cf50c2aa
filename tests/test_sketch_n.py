"""Device-side N handling: the compacted-window kernel must be bit-exact
with the NumPy ground truth (nthash_np.sketch_codes, itself pinned by the
reference's committed indexlr TSV goldens for N-containing scaffolds_2/3).

Reference semantics (btllib indexlr): minimizer windows run over the
sequence of *valid* k-mers — windows span N gaps, and a valid stretch
shorter than w emits nothing.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from ntlink_jax.ops import nthash_np
from ntlink_jax.ops.sketch_jax import JaxSketcher, sketch_batch_kernel

K, W = 32, 100


def _rand_codes(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def _plant(rng, n, spans):
    c = _rand_codes(rng, n)
    for start, ln in spans:
        c[start : start + ln] = 4
    return c


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(21)
    L = 4096
    out = [
        _rand_codes(rng, L),                        # clean
        _plant(rng, L, [(2000, 1)]),                # single N mid-row
        _plant(rng, L, [(1000, 500)]),              # long gap run
        _plant(rng, L, [(0, 40)]),                  # N at row start
        _plant(rng, L, [(L - 40, 40)]),             # N at row end
        _plant(rng, L, [(300, 5), (400, 5), (500, 5), (900, 200)]),  # many
        _plant(rng, L, [(0, L)]),                   # all N
        _plant(rng, L, [(100, 3900)]),              # valid stretches < w
        _plant(rng, 2500, [(1200, 60)])[:2500],     # short row w/ gap
    ]
    return out


def test_compacted_kernel_matches_numpy(rows):
    L = max(len(c) for c in rows)
    B = len(rows)
    codes = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, c in enumerate(rows):
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    can_hi, can_lo, fwd, winner, emit = sketch_batch_kernel(
        jnp.asarray(codes), jnp.asarray(lengths), K, W, compact_invalid=True
    )
    can_hi, can_lo, fwd = map(np.asarray, (can_hi, can_lo, fwd))
    winner, emit = np.asarray(winner), np.asarray(emit)
    from ntlink_jax.ops.sketch_jax import finish_hash

    for r, c in enumerate(rows):
        ref = nthash_np.sketch_codes(c, K, W)
        sel = winner[r][emit[r]]
        np.testing.assert_array_equal(sel, ref.positions, f"row {r} positions")
        hi, lo = finish_hash(
            jnp.asarray(can_hi[r][sel]), jnp.asarray(can_lo[r][sel]), K
        )
        got_hash = (
            np.asarray(hi).astype(np.uint64) << np.uint64(32)
        ) | np.asarray(lo).astype(np.uint64)
        np.testing.assert_array_equal(got_hash, ref.hashes, f"row {r} hashes")
        np.testing.assert_array_equal(
            fwd[r][sel], ref.forward, f"row {r} strand"
        )


def test_sketch_stream_n_rows_on_device(rows):
    """End-to-end through the batched sketcher: N rows must produce exactly
    the NumPy sketches (and share batches per (pad, has_n) bucket)."""
    sk = JaxSketcher(batch_bases=64 * 4096)
    named = [(f"s{i}", c) for i, c in enumerate(rows)]
    got = {n: m for n, _, m in sk.sketch_stream(iter(named), K, W)}
    for i, c in enumerate(rows):
        ref = nthash_np.sketch_codes(c, K, W)
        m = got[f"s{i}"]
        np.testing.assert_array_equal(m.positions, ref.positions, f"s{i}")
        np.testing.assert_array_equal(m.hashes, ref.hashes, f"s{i}")
        np.testing.assert_array_equal(m.forward, ref.forward, f"s{i}")


def test_compacted_kernel_random_property():
    """Randomized N placement across densities and (k, w) shapes."""
    rng = np.random.default_rng(99)
    from ntlink_jax.ops.sketch_jax import finish_hash
    import jax.numpy as jnp

    for trial in range(6):
        k = int(rng.integers(12, 48))
        w = int(rng.integers(2, 160))
        L = int(rng.integers(k + w + 10, 3000))
        c = _rand_codes(rng, L)
        # random N density 0..20%
        n_bad = int(L * rng.random() * 0.2)
        c[rng.integers(0, L, n_bad)] = 4
        can_hi, can_lo, fwd, winner, emit = sketch_batch_kernel(
            jnp.asarray(c[None, :]), jnp.asarray([L], jnp.int32), k, w,
            compact_invalid=True,
        )
        ref = nthash_np.sketch_codes(c, k, w)
        sel = np.asarray(winner)[0][np.asarray(emit)[0]]
        np.testing.assert_array_equal(
            sel, ref.positions, f"trial {trial} k={k} w={w} L={L}"
        )
        hi, lo = finish_hash(
            jnp.asarray(np.asarray(can_hi)[0][sel]),
            jnp.asarray(np.asarray(can_lo)[0][sel]),
            k,
        )
        got = (
            np.asarray(hi).astype(np.uint64) << np.uint64(32)
        ) | np.asarray(lo).astype(np.uint64)
        np.testing.assert_array_equal(got, ref.hashes)


def test_sketch_stream_n_rows_small_k():
    """Alternate (k, w) shapes (overlap 15/5, gap-fill 20/10) with gaps."""
    rng = np.random.default_rng(33)
    for k, w in ((15, 5), (20, 10)):
        rows = [
            _plant(rng, 3000, [(500, 120), (1500, 7)]),
            _plant(rng, 3000, [(0, 100), (2900, 100)]),
        ]
        sk = JaxSketcher(batch_bases=8 * 4096)
        got = {
            n: m
            for n, _, m in sk.sketch_stream(
                iter((f"x{i}", c) for i, c in enumerate(rows)), k, w
            )
        }
        for i, c in enumerate(rows):
            ref = nthash_np.sketch_codes(c, k, w)
            m = got[f"x{i}"]
            np.testing.assert_array_equal(m.positions, ref.positions)
            np.testing.assert_array_equal(m.hashes, ref.hashes)
            np.testing.assert_array_equal(m.forward, ref.forward)
