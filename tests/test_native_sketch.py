"""Native C sketcher (native/sketch.c): bit-exact vs the NumPy ground truth
(itself golden-validated against the reference indexlr TSVs) and the raw
anchor payload contract used by HostMapper / the native chain loop."""
import numpy as np
import pytest

from ntlink_jax.native import sketch_module
from ntlink_jax.ops import nthash_np as nt

sm = sketch_module()
pytestmark = pytest.mark.skipif(sm is None, reason="C build unavailable")


@pytest.mark.parametrize("k,w", [(32, 100), (15, 5), (20, 10), (24, 250),
                                 (33, 10), (41, 7), (2, 1)])
def test_sketch_matches_numpy(k, w):
    rng = np.random.default_rng(k * 1000 + w)
    for n in (0, k - 1, k, k + w, 500, 4097):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        if n > 20:  # sprinkle Ns: windows must span the gaps
            codes[rng.integers(0, n, max(1, n // 40))] = 4
        ref = nt.sketch_codes(codes, k, w)
        cnt, hb, pb, fb = sm.sketch(np.ascontiguousarray(codes), k, w)
        assert cnt == len(ref)
        assert np.array_equal(np.frombuffer(hb, np.uint64), ref.hashes)
        assert np.array_equal(np.frombuffer(pb, np.int64), ref.positions)
        assert np.array_equal(
            np.frombuffer(fb, np.uint8).astype(bool), ref.forward
        )


def test_all_n_sequence():
    codes = np.full(300, 4, np.uint8)
    cnt, hb, pb, fb = sm.sketch(codes, 32, 100)
    assert cnt == 0


def test_fast_hash_matches_gather():
    """The log-doubling NumPy hasher == the O(n*k) gather reference."""
    rng = np.random.default_rng(3)
    for k in (2, 8, 20, 24, 31, 32, 33, 41, 64):
        codes = rng.integers(0, 4, 700).astype(np.uint8)
        codes[rng.integers(0, 700, 12)] = 4
        a = nt.hash_kmers(codes, k)
        b = nt.hash_kmers_gather(codes, k)
        assert np.array_equal(a.out_hash, b.out_hash)
        assert np.array_equal(a.canonical, b.canonical)
        assert np.array_equal(a.forward, b.forward)
        assert np.array_equal(a.valid, b.valid)


def test_sketch_join_matches_lookup_many():
    """sketch_join == sketch + ContigIndex.lookup_many, payload-for-payload."""
    from ntlink_jax.index import ContigIndex

    rng = np.random.default_rng(11)
    k, w = 32, 100
    contig = "".join("ACGT"[c] for c in rng.integers(0, 4, 50_000))
    index = ContigIndex.from_sketches(
        [("c1", nt.sketch_sequence(contig, k, w))]
    )
    read = contig[10_000:25_000]
    codes = nt.encode(read)
    res = sm.sketch_join(
        codes, k, w,
        np.ascontiguousarray(index.hashes),
        np.ascontiguousarray(index.contig_ids, dtype=np.int32),
        np.ascontiguousarray(index.positions, dtype=np.int32),
        np.ascontiguousarray(index.strands.astype(np.uint8)),
    )
    assert res is not None
    n, rpos_b, cid_b, cpos_b, sbits_b, hi_b, lo_b = res

    mins = nt.sketch_codes(codes, k, w)
    found, cid, cpos, cstrand = index.lookup_many(mins.hashes)
    assert n == int(found.sum()) > 0
    assert np.array_equal(
        np.frombuffer(rpos_b, np.int32), mins.positions[found].astype(np.int32)
    )
    assert np.array_equal(np.frombuffer(cid_b, np.int32), cid[found])
    assert np.array_equal(np.frombuffer(cpos_b, np.int32), cpos[found])
    sbits = cstrand[found].astype(np.int32) | (
        mins.forward[found].astype(np.int32) << 1
    )
    assert np.array_equal(np.frombuffer(sbits_b, np.int32), sbits)
    hashes = mins.hashes[found]
    assert np.array_equal(
        np.frombuffer(hi_b, np.int32).view(np.uint32),
        (hashes >> np.uint64(32)).astype(np.uint32),
    )
    assert np.array_equal(
        np.frombuffer(lo_b, np.int32).view(np.uint32),
        (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


def test_host_mapper_matches_device_semantics():
    """HostMapper raw payloads == DeviceMapper host fallback payloads."""
    from ntlink_jax.device_map import DeviceMapper
    from ntlink_jax.host_map import HostMapper
    from ntlink_jax.index import ContigIndex

    rng = np.random.default_rng(5)
    k, w = 32, 100
    contig = "".join("ACGT"[c] for c in rng.integers(0, 4, 40_000))
    index = ContigIndex.from_sketches(
        [("c1", nt.sketch_sequence(contig, k, w))]
    )
    reads = []
    for i in range(8):
        s = int(rng.integers(0, 20_000))
        seq = contig[s : s + 12_000]
        codes = nt.encode(seq)
        if i % 2:  # interior Ns: windows must span gaps identically
            codes = codes.copy()
            codes[rng.integers(0, len(codes), 40)] = 4
        reads.append((f"r{i}", codes))
    hm = HostMapper(index, k, w, threads=2)
    dm = DeviceMapper(index, k, w, use_mesh=False)
    host = {n: raw for n, _, raw in hm.map_stream_raw(iter(reads))}
    for name, codes in reads:
        want = dm._host_map_raw(codes)
        got = host[name]
        assert (want is None) == (got is None)
        if want is None:
            continue
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
