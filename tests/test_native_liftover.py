"""Native C liftover == Python liftover, byte for byte.

Covers: +/- orientations, self (pass-through) placements, unplaced contigs
(empty-hit rows that still drive subsume bookkeeping), out-of-range anchor
drops, same-scaffold run merging, nested-run subsumption, and
non-monotonic-concatenation drops.
"""
import numpy as np
import pytest

import ntlink_jax.liftover as lift_mod
from ntlink_jax.native import liftover_module


def _write_agp(path, rows):
    with open(path, "w") as fh:
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")


def _run_both(tmp_path, monkeypatch, verbose_lines, agp_rows, k=32):
    vp = tmp_path / "verbose.tsv"
    vp.write_text("".join(line + "\n" for line in verbose_lines))
    ap = tmp_path / "round.agp"
    _write_agp(ap, agp_rows)

    native_out = tmp_path / "native.tsv"
    assert liftover_module() is not None
    lift_mod.liftover_mappings(str(vp), str(ap), str(native_out), k)

    python_out = tmp_path / "python.tsv"
    import ntlink_jax.native as native_pkg

    monkeypatch.setattr(native_pkg, "liftover_module", lambda: None)
    lift_mod.liftover_mappings(str(vp), str(ap), str(python_out), k)

    return native_out.read_bytes(), python_out.read_bytes()


def _row(read, ctg, hits):
    body = " ".join(f"{cp}:{cs}_{rp}:{rs}" for cp, cs, rp, rs in hits)
    return f"{read}\t{ctg}\t{len(hits)}\t{body}"


def test_handcrafted_scenarios(tmp_path, monkeypatch):
    # scaffold S1 = ctgA(+) then ctgB(-); ctgC unplaced; ctgD self-named
    agp = [
        ("S1", 1, 1000, 1, "W", "ctgA", 1, 1000, "+"),
        ("S1", 1101, 2100, 3, "W", "ctgB", 1, 1000, "-"),
        ("S1", 1001, 1100, 2, "N", 100, "scaffold", "yes", "paired-ends"),
        ("ctgD", 1, 500, 1, "W", "ctgD", 1, 500, "+"),
    ]
    lines = [
        # same-scaffold merge: A then B rows both land on S1
        _row("r1", "ctgA", [(10, "+", 100, "+"), (200, "+", 300, "+")]),
        _row("r1", "ctgB", [(900, "-", 500, "+"), (700, "-", 700, "+")]),
        # unplaced contig between two sightings: subsume bookkeeping
        _row("r2", "ctgA", [(10, "+", 50, "+")]),
        _row("r2", "ctgC", [(5, "+", 120, "+")]),
        _row("r2", "ctgA", [(400, "+", 400, "+")]),
        # repeated unknown contig subsumes the scaffold between sightings
        _row("r3", "ctgC", [(5, "+", 10, "+")]),
        _row("r3", "ctgB", [(100, "+", 200, "+")]),
        _row("r3", "ctgC", [(50, "+", 400, "+")]),
        # self-named placement passes through untouched
        _row("r4", "ctgD", [(17, "-", 40, "+"), (120, "+", 200, "-")]),
        # out-of-range anchors dropped (pos > ctg_end - k)
        _row("r5", "ctgA", [(995, "+", 10, "+"), (30, "+", 60, "+")]),
        # non-monotonic concatenation across merged rows: dropped
        _row("r6", "ctgA", [(500, "+", 10, "+")]),
        _row("r6", "ctgB", [(900, "-", 200, "+")]),
        _row("r6", "ctgA", [(600, "+", 300, "+")]),
    ]
    got, exp = _run_both(tmp_path, monkeypatch, lines, agp)
    assert got == exp
    assert b"S1" in exp  # sanity: something actually lifted


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_scenarios(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(seed)
    n_ctg = 12
    agp = []
    pos = 1
    # half the contigs placed on two scaffolds, two self rows, rest unplaced
    placed = {}
    for i in range(n_ctg):
        name = f"c{i}"
        if i < 6:
            scaf = "S%d" % (i % 2)
            length = int(rng.integers(300, 1200))
            ori = "+" if rng.random() < 0.5 else "-"
            agp.append((scaf, pos, pos + length - 1, 1, "W", name, 1, length, ori))
            placed[name] = length
            pos += length + 10
        elif i < 8:
            length = int(rng.integers(300, 1200))
            agp.append((name, 1, length, 1, "W", name, 1, length, "+"))
            placed[name] = length
    lines = []
    for r in range(150):
        n_rows = int(rng.integers(1, 5))
        ctgs = rng.choice(n_ctg, size=n_rows, replace=True)
        rpos = 0
        for c in ctgs:
            name = f"c{c}"
            n_hits = int(rng.integers(1, 6))
            limit = placed.get(name, 800)
            cps = sorted(
                int(x) for x in rng.integers(0, max(limit + 50, 100), n_hits)
            )
            if rng.random() < 0.5:
                cps = cps[::-1]
            hits = []
            for cp in cps:
                rpos += int(rng.integers(1, 50))
                hits.append(
                    (cp, "+" if rng.random() < 0.5 else "-", rpos,
                     "+" if rng.random() < 0.5 else "-")
                )
            lines.append(_row(f"r{r}", name, hits))
    got, exp = _run_both(tmp_path, monkeypatch, lines, agp)
    assert got == exp


def test_liftover_cli_target(tmp_path, monkeypatch):
    """`ntlink liftover agp=... mappings=...` — standalone drop-in for the
    reference's ntlink_liftover_mappings.py console script."""
    from ntlink_jax.cli import main

    agp = [("S1", 1, 1000, 1, "W", "ctgA", 1, 1000, "+")]
    _write_agp(tmp_path / "x.agp", agp)
    (tmp_path / "m.tsv").write_text(_row("r1", "ctgA", [(10, "+", 5, "+")]) + "\n")
    monkeypatch.chdir(tmp_path)
    rc = main(["liftover", "agp=x.agp", "mappings=m.tsv", "out=o.tsv", "k=32"])
    assert rc == 0
    assert (tmp_path / "o.tsv").read_text() == "r1\tS1\t1\t10:+_5:+\n"
