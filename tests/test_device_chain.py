"""On-device chaining (mesh.chain_anchors_device) parity vs the exact host
chain (mapping.chain_read_hits / native chain.c), including the structures
the acceptance stages exist for: z-filtered contigs, noisy spans, nested
repeat sightings (specific-mode subsume), self-dooming triple sightings,
and the RUN_LANES overflow escape. Reference semantics:
ntlink_utils.py:200-294."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ntlink_jax.mapping import AnchorHit, chain_read_hits  # noqa: E402
from ntlink_jax.parallel.mesh import (  # noqa: E402
    RUN_LANES,
    chain_anchors_device,
)

K, Z = 32, 1000


def _host_keep(cids, cpos, rpos, read_len, clen):
    """Expected keep mask from the reference-semantics host chain."""
    names = [f"c{i}" for i in range(len(clen))]
    lengths = {names[i]: int(clen[i]) for i in range(len(clen))}
    hits = [
        (names[c], AnchorHit(0, int(cp), "+", int(rp), "+"))
        for c, cp, rp in zip(cids, cpos, rpos)
    ]
    runs = chain_read_hits(hits, read_len, lengths, K, Z, x=0.0)
    accepted = []
    for r in runs:
        accepted.extend((r.contig, h.ctg_pos, h.read_pos) for h in r.hits)
    # map accepted (contig, cpos, rpos) back to input positions, in order
    keep = np.zeros(len(cids), bool)
    ai = 0
    for i, (c, cp, rp) in enumerate(zip(cids, cpos, rpos)):
        if ai < len(accepted) and accepted[ai] == (names[c], cp, rp):
            keep[i] = True
            ai += 1
    assert ai == len(accepted)
    return keep


def _device_keep(rows, clen, read_lens, S=32):
    B = len(rows)
    found = np.zeros((B, S), bool)
    cid = np.zeros((B, S), np.int32)
    cpos = np.zeros((B, S), np.int32)
    for b, (cids, cps) in enumerate(rows):
        n = len(cids)
        found[b, :n] = True
        cid[b, :n] = cids
        cpos[b, :n] = cps
    keep, overflow = chain_anchors_device(
        jnp.asarray(found), jnp.asarray(cid), jnp.asarray(cpos),
        jnp.asarray(np.asarray(read_lens, np.int32)),
        jnp.asarray(clen), jnp.int32(Z), K,
    )
    return np.asarray(keep), np.asarray(overflow)


def test_structured_cases():
    clen = np.array([5000, 5000, 500, 5000, 5000], np.int32)  # c2 fails z
    rl = 2000
    cases = [
        # simple two-contig split
        ([0, 0, 1, 1], [10, 50, 5, 40]),
        # z filter drops contig 2 entirely
        ([0, 2, 2, 1], [10, 5, 40, 7]),
        # noisy span: contig 0 anchors 4000 apart on a 2000-base read
        ([0, 0, 1, 1], [10, 4500, 5, 40]),
        # subsume: c1 nested between two sightings of c0 -> c1 dooms
        ([0, 0, 1, 0, 3], [10, 50, 5, 90, 7]),
        # self-dooming triple sighting of c0 (middle occurrence between
        # first and last -> c0 itself doomed)
        ([0, 1, 0, 3, 0], [10, 5, 50, 7, 90]),
        # adjacent runs of same contig after a dropped middle run merge
        ([0, 2, 0, 1], [10, 5, 50, 7]),
        # single anchors only
        ([4], [123]),
    ]
    rows = []
    expected = []
    for cids, cps in cases:
        rpos = list(range(0, 10 * len(cids), 10))
        rows.append((np.asarray(cids, np.int32), np.asarray(cps, np.int32)))
        expected.append(_host_keep(cids, cps, rpos, rl, clen))
    keep, overflow = _device_keep(rows, clen, [rl] * len(rows))
    assert not overflow.any()
    for b, exp in enumerate(expected):
        got = keep[b, : len(exp)]
        assert np.array_equal(got, exp), (b, got, exp)
        assert not keep[b, len(exp):].any()


def test_random_parity():
    rng = np.random.default_rng(11)
    clen = rng.integers(200, 8000, 12).astype(np.int32)
    rows, expected, rls = [], [], []
    for _ in range(64):
        n = int(rng.integers(1, 30))
        cids = rng.integers(0, 12, n).astype(np.int32)
        cps = rng.integers(0, 6000, n).astype(np.int32)
        rl = int(rng.integers(500, 4000))
        rpos = np.sort(rng.integers(0, rl, n)).astype(np.int32)
        rows.append((cids, cps))
        rls.append(rl)
        expected.append(_host_keep(cids, cps, rpos.tolist(), rl, clen))
    keep, overflow = _device_keep(rows, clen, rls)
    assert not overflow.any()
    for b, exp in enumerate(expected):
        assert np.array_equal(keep[b, : len(exp)], exp), b


def test_random_parity_large_contig_count():
    """> NOISY_ONEHOT_MAX contigs forces the scatter form of the
    noisy-span filter — parity must hold there too."""
    from ntlink_jax.parallel.mesh import NOISY_ONEHOT_MAX

    rng = np.random.default_rng(31)
    nc = NOISY_ONEHOT_MAX + 72
    clen = rng.integers(200, 8000, nc).astype(np.int32)
    rows, expected, rls = [], [], []
    for _ in range(32):
        n = int(rng.integers(1, 30))
        cids = rng.integers(0, nc, n).astype(np.int32)
        cps = rng.integers(0, 6000, n).astype(np.int32)
        rl = int(rng.integers(500, 4000))
        rpos = np.sort(rng.integers(0, rl, n)).astype(np.int32)
        rows.append((cids, cps))
        rls.append(rl)
        expected.append(_host_keep(cids, cps, rpos.tolist(), rl, clen))
    keep, overflow = _device_keep(rows, clen, rls)
    assert not overflow.any()
    for b, exp in enumerate(expected):
        assert np.array_equal(keep[b, : len(exp)], exp), b


def test_runs_summary_parity():
    """summarize_runs_device (the O(runs) D2H payload) must reproduce the
    native chain.c run rows exactly — cid, merged anchor count, first and
    terminal anchor fields — over structured + randomized anchor sets,
    including merge-after-subsume cases."""
    from ntlink_jax.native import chain_module
    from ntlink_jax.parallel.mesh import summarize_runs_device

    cm = chain_module()
    if cm is None:
        pytest.skip("native chain module not built")

    rng = np.random.default_rng(23)
    clen = rng.integers(200, 8000, 12).astype(np.int32)
    names = [f"c{i}" for i in range(len(clen))]
    chainer = cm.Chainer(clen, names)

    cases = []
    # structured: subsume-merge (middle run dooms, flanks merge), triple
    # sighting, z filter, plus random rows
    structured = [
        ([0, 1, 0, 1, 0], [10, 5, 50, 9, 90]),      # c1/c0 self-dooming mix
        ([0, 3, 0, 1], [10, 5, 50, 7]),              # merge after doom
        ([5, 5, 5], [10, 30, 60]),                   # one run, count 3
    ]
    for cids, cps in structured:
        n = len(cids)
        cases.append((
            np.asarray(cids, np.int32), np.asarray(cps, np.int32),
            np.arange(0, 10 * n, 10, dtype=np.int32),
            rng.integers(0, 4, n).astype(np.int32), 2000,
        ))
    for _ in range(48):
        n = int(rng.integers(1, 30))
        rl = int(rng.integers(500, 4000))
        cases.append((
            rng.integers(0, 12, n).astype(np.int32),
            rng.integers(0, 6000, n).astype(np.int32),
            np.sort(rng.integers(0, rl, n)).astype(np.int32),
            rng.integers(0, 4, n).astype(np.int32),
            rl,
        ))

    B, S = len(cases), 32
    found = np.zeros((B, S), bool)
    cid = np.zeros((B, S), np.int32)
    cpos = np.zeros((B, S), np.int32)
    rposw = np.zeros((B, S), np.int32)
    for b, (cids, cps, rps, sbs, _) in enumerate(cases):
        n = len(cids)
        found[b, :n] = True
        cid[b, :n] = cids
        cpos[b, :n] = cps
        rposw[b, :n] = rps | (sbs << 29)
    rls = np.asarray([c[4] for c in cases], np.int32)
    keep, overflow = chain_anchors_device(
        jnp.asarray(found), jnp.asarray(cid), jnp.asarray(cpos),
        jnp.asarray(rls), jnp.asarray(clen), jnp.int32(Z), K,
    )
    assert not np.asarray(overflow).any()
    valid, r_cid, r_cnt, f_cpos, l_cpos, f_rw, l_rw = (
        np.asarray(a) for a in summarize_runs_device(
            keep, jnp.asarray(cid), jnp.asarray(cpos), jnp.asarray(rposw)
        )
    )

    # ground truth: native chain.c full filters + run rows
    offs = np.zeros(B + 1, np.int64)
    np.cumsum([len(c[0]) for c in cases], out=offs[1:])
    runs_b, ro_b, _, _ = chainer.chain_batch(
        np.concatenate([c[0] for c in cases]),
        np.concatenate([c[1] for c in cases]),
        np.concatenate([c[2] for c in cases]),
        np.concatenate([c[3] for c in cases]),
        offs, rls, None, K, Z, 0, 0.0, 0, 0,
    )
    rr = np.frombuffer(runs_b, np.int32).reshape(-1, 8)
    ro = np.frombuffer(ro_b, np.int32)
    for b in range(B):
        exp = rr[ro[b] : ro[b + 1]]
        nv = int(valid[b].sum())
        assert nv == exp.shape[0], (b, nv, exp)
        got = np.stack(
            [
                r_cid[b, :nv], r_cnt[b, :nv],
                f_cpos[b, :nv], f_rw[b, :nv] & 0x1FFFFFFF,
                (f_rw[b, :nv] >> 29) & 3,
                l_cpos[b, :nv], l_rw[b, :nv] & 0x1FFFFFFF,
                (l_rw[b, :nv] >> 29) & 3,
            ],
            axis=1,
        )
        assert np.array_equal(got, exp), (b, got, exp)


def test_run_overflow_flags_row():
    # alternate contigs every anchor -> one run per anchor; > RUN_LANES
    # runs must flag the row (host redo), not silently mis-chain
    n = RUN_LANES + 8
    cids = np.array([i % 2 for i in range(n)], np.int32)
    cps = np.full(n, 10, np.int32)
    clen = np.array([5000, 5000], np.int32)
    keep, overflow = _device_keep([(cids, cps)], clen, [2000], S=128)
    assert overflow[0]
    assert not keep[0].any()
