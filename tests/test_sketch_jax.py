"""JAX sketch backend parity vs the NumPy reference (bit-exact)."""
import numpy as np
import pytest

from ntlink_jax.ops import nthash_np
from ntlink_jax.ops.sketch_jax import JaxSketcher
from ntlink_jax.seqio import stream_fastx



def random_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.mark.parametrize("k,w", [(32, 100), (15, 5), (20, 10), (40, 100)])
def test_jax_matches_numpy_random(k, w):
    rng = np.random.default_rng(k * 1000 + w)
    seqs = [("s%d" % i, random_seq(rng, int(n))) for i, n in
            enumerate(rng.integers(w + k + 5, 5000, size=12))]
    # include one with N (falls back to numpy path) and one short
    seqs.append(("withn", random_seq(rng, 800) + "N" + random_seq(rng, 800)))
    seqs.append(("short", "ACGTACG"))
    sk = JaxSketcher(batch_bases=50_000)
    got = {name: m for name, _, m in sk.sketch_stream(iter(seqs), k, w)}
    for name, seq in seqs:
        ref = nthash_np.sketch_sequence(seq, k, w)
        g = got[name]
        assert np.array_equal(g.positions, ref.positions), name
        assert np.array_equal(g.hashes, ref.hashes), name
        assert np.array_equal(g.forward, ref.forward), name


def test_jax_matches_numpy_real_contigs(ref_tests_dir):
    sk = JaxSketcher()
    seqs = [(r.name, r.seq) for r in stream_fastx(f"{ref_tests_dir}/scaffolds_2.fa")]
    got = {name: m for name, _, m in sk.sketch_stream(iter(seqs), 32, 100)}
    for name, seq in seqs:
        ref = nthash_np.sketch_sequence(seq, 32, 100)
        g = got[name]
        assert np.array_equal(g.hashes, ref.hashes)
        assert np.array_equal(g.positions, ref.positions)
        assert np.array_equal(g.forward, ref.forward)


@pytest.mark.parametrize("k,w", [(32, 100), (15, 5)])
def test_long_sequence_chunking(k, w):
    """Sequences past MAX_PAD split into window-aligned device chunks and
    merge bit-exactly (incl. the cross-chunk winner dedup at seams)."""
    rng = np.random.default_rng(k + w)
    sk = JaxSketcher(batch_bases=50_000)
    sk.MAX_PAD = 4096  # shrink the gate so chunking triggers at test scale
    S = sk.MAX_PAD - (k + w - 2)
    lengths = [
        4097,                # one base past the gate -> 2 chunks
        3 * S + (k + w - 2),  # exact multiple of the window stride
        3 * S + (k + w - 2) + 1,
        20_000,              # 5 chunks
    ]
    seqs = []
    for i, n in enumerate(lengths):
        seq = random_seq(rng, n)
        # plant a repeated low-complexity block straddling the first seam so
        # a single winner's reign crosses the chunk boundary (exercises the
        # seam dedup, not just clean handoffs)
        block = "ACGT" * ((k + w) // 4 + 2)
        cut = S - len(block) // 2
        seq = seq[:cut] + block + seq[cut + len(block):]
        seqs.append((f"long{i}", seq))
    seqs.append(("normal", random_seq(rng, 2000)))  # unchunked row mixed in
    got = {name: m for name, _, m in sk.sketch_stream(iter(seqs), k, w)}
    for name, seq in seqs:
        ref = nthash_np.sketch_sequence(seq, k, w)
        g = got[name]
        assert np.array_equal(g.positions, ref.positions), name
        assert np.array_equal(g.hashes, ref.hashes), name
        assert np.array_equal(g.forward, ref.forward), name


def test_long_sequence_with_n_falls_back_exactly():
    """Oversized rows containing N take the exact host path (chunk seams
    do not compose with compacted-window semantics)."""
    rng = np.random.default_rng(3)
    k, w = 15, 5
    sk = JaxSketcher(batch_bases=50_000)
    sk.MAX_PAD = 4096
    seq = random_seq(rng, 3000) + "NNN" + random_seq(rng, 3000)
    got = {n: m for n, _, m in sk.sketch_stream(iter([("x", seq)]), k, w)}
    ref = nthash_np.sketch_sequence(seq, k, w)
    assert np.array_equal(got["x"].hashes, ref.hashes)
    assert np.array_equal(got["x"].positions, ref.positions)
    assert np.array_equal(got["x"].forward, ref.forward)
    assert sk.host_fallbacks == 1


def test_stream_preserves_order():
    rng = np.random.default_rng(7)
    seqs = [(f"r{i}", random_seq(rng, 1200 + i)) for i in range(9)]
    sk = JaxSketcher(batch_bases=4000)
    names = [name for name, _, _ in sk.sketch_stream(iter(seqs), 16, 10)]
    assert names == [name for name, _ in seqs]
