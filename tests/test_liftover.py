"""Liftover coordinate-math unit tests (hand-computed expectations,
reference ntlink_liftover_mappings.py:61-118)."""

from ntlink_jax.liftover import liftover_mappings


def write_agp(path, rows):
    with open(path, "w") as fh:
        for row in rows:
            fh.write("\t".join(str(x) for x in row) + "\n")


def write_verbose(path, rows):
    with open(path, "w") as fh:
        for row in rows:
            fh.write("\t".join(row) + "\n")


def run(tmp_path, agp_rows, verbose_rows, k=10):
    agp = tmp_path / "x.agp"
    verbose = tmp_path / "x.tsv"
    out = tmp_path / "out.tsv"
    write_agp(agp, agp_rows)
    write_verbose(verbose, verbose_rows)
    liftover_mappings(str(verbose), str(agp), str(out), k)
    return [l.rstrip("\n") for l in open(out)]


def test_plus_strand_offset(tmp_path):
    # c1 placed forward at scaffold position 101.. (offset 100), region 11..100
    agp = [("s0", 101, 200, 1, "W", "c1", 11, 100, "+")]
    verbose = [("r1", "c1", "2", "20:+_5:+ 30:-_15:-")]
    # new_pos = 100 + (pos - 10): 20 -> 110, 30 -> 120; strands preserved
    assert run(tmp_path, agp, verbose) == [
        "r1\ts0\t2\t110:+_5:+ 120:-_15:-"
    ]


def test_minus_strand_flip(tmp_path):
    agp = [("s0", 101, 200, 1, "W", "c1", 11, 100, "-")]
    verbose = [("r1", "c1", "2", "20:+_5:+ 30:-_15:-")]
    # ctg_len = 90; new_pos = 100 + (90 - (pos-10)) - 10 = 190 - pos
    # 20 -> 170 (flip to -), 30 -> 160 (flip to +); order kept, so the
    # concatenation is decreasing -> monotonic, emitted as-is
    assert run(tmp_path, agp, verbose) == [
        "r1\ts0\t2\t170:-_5:+ 160:+_15:-"
    ]


def test_out_of_range_anchors_dropped(tmp_path):
    agp = [("s0", 101, 200, 1, "W", "c1", 11, 100, "+")]
    # pos 5 < ctg_start-1=10; pos 95 > ctg_end-k=90: both dropped
    verbose = [("r1", "c1", "3", "5:+_1:+ 50:+_10:+ 95:+_20:+")]
    assert run(tmp_path, agp, verbose) == ["r1\ts0\t1\t140:+_10:+"]


def test_unplaced_contig_kept_as_is(tmp_path):
    agp = [("s0", 101, 200, 1, "W", "c1", 11, 100, "+")]
    verbose = [("r1", "c2", "1", "7:+_3:+")]
    # c2 not in the AGP: mapping survives untouched under its own name...
    # but with zero adjusted mappings it is dropped from the output
    assert run(tmp_path, agp, verbose) == []


def test_self_named_scaffold_identity(tmp_path):
    # path_id == contig id: coordinates pass through unchanged
    agp = [("c1", 1, 90, 1, "W", "c1", 11, 100, "+")]
    verbose = [("r1", "c1", "1", "50:-_9:+")]
    assert run(tmp_path, agp, verbose) == ["r1\tc1\t1\t50:-_9:+"]


def test_merged_runs_and_non_monotonic_drop(tmp_path):
    # two contigs land in one scaffold; runs merge in order
    agp = [
        ("s0", 1, 90, 1, "W", "c1", 1, 90, "+"),
        ("s0", 101, 190, 3, "W", "c2", 1, 90, "+"),
    ]
    verbose = [
        ("r1", "c1", "1", "10:+_5:+"),
        ("r1", "c2", "1", "20:+_200:+"),
    ]
    # c1 10 -> 10; c2 20 -> 120: merged increasing -> one row on s0
    assert run(tmp_path, agp, verbose) == ["r1\ts0\t2\t10:+_5:+ 120:+_200:+"]

    # non-monotonic concatenation is dropped entirely
    verbose = [
        ("r1", "c2", "1", "20:+_5:+"),    # 120
        ("r1", "c1", "1", "10:+_200:+"),  # 10 -> 120,10 not monotonic? order
    ]
    # rows arrive c2 then c1: concatenated positions 120, 10 -> decreasing,
    # which IS monotonic -> kept
    assert run(tmp_path, agp, verbose) == ["r1\ts0\t2\t120:+_5:+ 10:+_200:+"]
