"""Unit tests for chaining modes (subsume marking, repeat filter, noisy
filter) — semantics validated by inspection against the reference
(ntlink_utils.py:200-294, ntlink_pair.py:368-374)."""
from ntlink_jax.mapping import AnchorHit, chain_read_hits
from ntlink_jax.pipeline import _host_hit_stream_codes  # noqa: F401 (import check)


def mk_hits(pattern):
    """pattern: list of (contig, ctg_pos); read positions increase by 100."""
    return [
        (ctg, AnchorHit(1000 + i, pos, "+", i * 100, "+"))
        for i, (ctg, pos) in enumerate(pattern)
    ]


LENGTHS = {"A": 5000, "B": 5000, "C": 5000, "S": 100}


def contigs_of(runs):
    return [r.contig for r in runs]


def test_specific_mode_cascading_subsume():
    # run order A B A C B: A-repeat subsumes B; B-repeat subsumes A and C
    hits = mk_hits([("A", 10), ("B", 10), ("A", 120), ("C", 10), ("B", 130)])
    runs = chain_read_hits(hits, 1000, LENGTHS, k=32, z=100, sensitive=False)
    assert runs == []


def test_sensitive_mode_run_level_subsume():
    hits = mk_hits([("A", 10), ("B", 10), ("A", 120), ("C", 10), ("B", 130)])
    runs = chain_read_hits(hits, 1000, LENGTHS, k=32, z=100, sensitive=True)
    assert contigs_of(runs) == ["A", "B"]
    # surviving runs: first A run and last B run only
    assert runs[0].hit_count == 1 and runs[1].hit_count == 1


def test_simple_nested_contig_subsumed_and_merged():
    # A B A -> B subsumed, A runs merged
    hits = mk_hits([("A", 10), ("B", 10), ("A", 120)])
    runs = chain_read_hits(hits, 1000, LENGTHS, k=32, z=100)
    assert contigs_of(runs) == ["A"]
    assert runs[0].hit_count == 2


def test_z_filter_drops_short_contigs():
    hits = mk_hits([("A", 10), ("S", 10), ("B", 10)])
    runs = chain_read_hits(hits, 1000, LENGTHS, k=32, z=1000)
    assert contigs_of(runs) == ["A", "B"]


def test_noisy_span_filter():
    # contig span 4000 > read_len + k -> contig dropped entirely
    hits = mk_hits([("A", 10), ("A", 4010), ("B", 50)])
    runs = chain_read_hits(hits, read_length=3000, contig_lengths=LENGTHS,
                           k=32, z=100)
    assert contigs_of(runs) == ["B"]
    # with a long enough read it survives
    runs = chain_read_hits(hits, read_length=4500, contig_lengths=LENGTHS,
                           k=32, z=100)
    assert contigs_of(runs) == ["A", "B"]


def test_noisy_fudge_factor():
    # x=1: threshold = min(read_len+k, read-span+k); ctg span 2000 over
    # read span 100 -> dropped
    hits = mk_hits([("A", 10), ("A", 2010)])
    runs = chain_read_hits(hits, 3000, LENGTHS, k=32, z=100, x=1.0)
    assert runs == []
    runs = chain_read_hits(hits, 3000, LENGTHS, k=32, z=100, x=0.0)
    assert contigs_of(runs) == ["A"]
