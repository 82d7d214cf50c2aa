"""Incremental in-order delivery of the device mapping stream.

map_stream_raw yields each read's result as soon as its batch has drained
(so the consumer's chaining overlaps later batches' wire/device time), but
the delivery order must stay exactly the input order and the payloads must
match the exact NumPy host path — across multiple pad buckets, multiple
flushed batches per bucket, and host-fallback reads (N bases / too-short)
interleaved between device reads. Reference contract: the per-read loop of
ntlink_pair.py:336-414 consumes mappings strictly in read order.
"""
import numpy as np
import pytest

from ntlink_jax.device_map import DeviceMapper
from ntlink_jax.index import ContigIndex
from ntlink_jax.ops import nthash_np

K, W = 32, 100


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(11)
    contig = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 120_000)])
    index = ContigIndex.from_sketches(
        [("ctg0", nthash_np.sketch_sequence(contig, K, W))]
    )
    reads = []
    for i in range(70):
        # alternate pad buckets (1024 and 2048) plus host-fallback shapes
        if i % 11 == 10:
            # interior N — batches via the compacted-window device path
            # under every index layout; alternate a lone N and a long run
            start = int(rng.integers(0, 100_000))
            seq = contig[start : start + 900]
            if i % 22 == 10:
                seq = seq[:400] + "N" + seq[401:]
            else:
                seq = seq[:300] + "N" * 60 + seq[360:]
        elif i % 7 == 6:
            seq = "ACG"  # shorter than k -> host fallback
        else:
            ln = 900 if i % 2 == 0 else 1800
            start = int(rng.integers(0, 100_000 - ln))
            seq = contig[start : start + ln]
        reads.append((f"r{i}", seq))
    return index, reads


def _expected(index, reads):
    """Ground truth via the mapper's own exact host path."""
    mapper = DeviceMapper(index, K, W, batch_bases=16_384, use_mesh=False)
    out = []
    for name, seq in reads:
        out.append((name, len(seq), mapper._host_map_raw(nthash_np.encode(seq))))
    return out


def test_incremental_delivery_order_and_parity(workload):
    index, reads = workload
    # tiny batch_bases: the 1024-pad bucket flushes every ~16 reads, the
    # 2048-pad bucket every ~8 -> many interleaved batches in flight
    mapper = DeviceMapper(index, K, W, batch_bases=16_384, use_mesh=False)
    expected = _expected(index, reads)

    got = list(mapper.map_stream_raw(iter(reads)))
    assert [(n, l) for n, l, _ in got] == [(n, l) for n, l, _ in expected]
    for (_, _, raw_g), (_, _, raw_e) in zip(got, expected):
        if raw_e is None:
            assert raw_g is None
            continue
        n_g, n_e = raw_g[0], raw_e[0]
        assert n_g == n_e
        for a, b in zip(raw_g[1:5], raw_e[1:5]):
            np.testing.assert_array_equal(np.asarray(a)[:n_g], np.asarray(b)[:n_e])


def test_mesh_path_n_reads_parity(workload):
    """N reads through the sharded (8-virtual-device) mapping step must
    match the exact host path (nmask rows shard like the code rows)."""
    index, reads = workload
    mapper = DeviceMapper(index, K, W, batch_bases=16_384, use_mesh=True)
    assert mapper.n_devices == 8
    expected = _expected(index, reads)
    got = list(mapper.map_stream_raw(iter(reads)))
    assert [(n, l) for n, l, _ in got] == [(n, l) for n, l, _ in expected]
    for (_, _, raw_g), (_, _, raw_e) in zip(got, expected):
        if raw_e is None:
            assert raw_g is None
            continue
        assert raw_g[0] == raw_e[0]
        for a, b in zip(raw_g[1:5], raw_e[1:5]):
            np.testing.assert_array_equal(
                np.asarray(a)[: raw_g[0]], np.asarray(b)[: raw_e[0]]
            )


def test_hash_sharded_path_n_reads_parity(workload):
    """N reads through the hash-sharded-index step (2-D mesh) must match
    the exact host path."""
    index, reads = workload
    mapper = DeviceMapper(
        index, K, W, batch_bases=16_384, use_mesh=True,
        index_sharding="hash", idx_shards=2,
    )
    expected = _expected(index, reads)
    got = list(mapper.map_stream_raw(iter(reads)))
    assert [(n, l) for n, l, _ in got] == [(n, l) for n, l, _ in expected]
    for (_, _, raw_g), (_, _, raw_e) in zip(got, expected):
        if raw_e is None:
            assert raw_g is None
            continue
        assert raw_g[0] == raw_e[0]
        for a, b in zip(raw_g[1:5], raw_e[1:5]):
            np.testing.assert_array_equal(
                np.asarray(a)[: raw_g[0]], np.asarray(b)[: raw_e[0]]
            )


def test_results_surface_before_stream_end(workload):
    """The overlap property: with multiple batches, at least one result is
    delivered before the input stream is exhausted (no all-at-the-end
    buffering). The drain is async, so wait deterministically: after enough
    reads to flush several batches, block until the work queue drains, then
    expect the next pull to release the completed front of the window."""
    index, reads = workload
    mapper = DeviceMapper(index, K, W, batch_bases=16_384, use_mesh=False)

    import time

    pulled = [0]

    def feeding():
        for i, r in enumerate(reads):
            if i == 50:
                # let in-flight batches drain so the delivery window can
                # advance at the next flush/fallback yield point
                time.sleep(0.5)
            pulled[0] += 1
            yield r

    stream = mapper.map_stream_raw(feeding())
    first_at = None
    for _ in stream:
        first_at = pulled[0]
        break
    # 70 reads total; the first completed batch must surface well before the
    # stream end (the old behavior only yielded after all 70)
    assert first_at is not None and first_at < len(reads)
