"""HybridSketcher: device + native-C thread pool over one stream, bit-exact
and order-preserving regardless of the split policy."""
import numpy as np
import pytest

from ntlink_jax.ops import nthash_np
from ntlink_jax.sketch import HybridSketcher, get_backend


def random_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def make_mixed_seqs(rng, k, w):
    seqs = [
        (f"s{i}", random_seq(rng, int(n)))
        for i, n in enumerate(rng.integers(w + k + 5, 6000, size=24))
    ]
    seqs.append(("withn", random_seq(rng, 900) + "NNN" + random_seq(rng, 900)))
    seqs.append(("short", "ACGTACG"))
    return seqs


@pytest.mark.parametrize("host_frac", [0.5, 0.0, 1.0, -1.0])
def test_hybrid_sketch_parity(host_frac, monkeypatch):
    # the stall rescue re-runs a slow path's items on the other path after
    # a wall-clock delay; under a loaded test host it could move every
    # item to one path, so the pinned split alone decides here
    from ntlink_jax.hybrid_map import HybridStream

    monkeypatch.setattr(HybridStream, "STALL_RESCUE_S", float("inf"))
    k, w = 20, 10
    rng = np.random.default_rng(11)
    seqs = make_mixed_seqs(rng, k, w)
    hs = HybridSketcher(threads=2, host_frac=host_frac, block_items=4)
    hs.device_backend.batch_bases = 20_000
    got = list(hs.sketch_stream(iter(seqs), k, w))
    assert [n for n, _, _ in got] == [n for n, _ in seqs]  # order
    for (name, seq), (gname, glen, m) in zip(seqs, got):
        ref = nthash_np.sketch_sequence(seq, k, w)
        assert glen == len(seq)
        assert np.array_equal(m.hashes, ref.hashes), name
        assert np.array_equal(m.positions, ref.positions), name
        assert np.array_equal(m.forward, ref.forward), name
    if host_frac == 0.5:
        assert hs.host_seqs > 0 and hs.device_seqs > 0  # both paths ran


def test_hybrid_sketch_long_chunked_rows():
    """Oversized rows chunk on the device path and sketch whole on the
    host path — identical either way."""
    k, w = 15, 5
    rng = np.random.default_rng(7)
    hs = HybridSketcher(threads=2, host_frac=0.5, block_items=2)
    hs.device_backend.batch_bases = 20_000
    hs.device_backend.MAX_PAD = 4096
    seqs = [(f"L{i}", random_seq(rng, 9000)) for i in range(6)]
    got = list(hs.sketch_stream(iter(seqs), k, w))
    for (name, seq), (_, _, m) in zip(seqs, got):
        ref = nthash_np.sketch_sequence(seq, k, w)
        assert np.array_equal(m.hashes, ref.hashes), name
        assert np.array_equal(m.positions, ref.positions), name


def test_get_backend_hybrid():
    b = get_backend("hybrid", threads=3)
    assert isinstance(b, HybridSketcher)
    assert b.threads == 3
