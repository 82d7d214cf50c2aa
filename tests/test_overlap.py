"""Overlap trim stage parity (scaffolds_4 has real negative-gap joins)."""
import filecmp
import os
import shutil

import pytest

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import scaffold_stage

from conftest import REF_TESTS_DIR


def run_case(tmp_path, monkeypatch, target, reads, k, w, merge_gap):
    shutil.copy(os.path.join(REF_TESTS_DIR, target), tmp_path / target)
    shutil.copy(os.path.join(REF_TESTS_DIR, reads), tmp_path / reads)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target=target, reads=[reads], k=k, w=w, z=1000, overlap=True,
        merge_gap=merge_gap, backend="numpy",
    )
    return cfg, scaffold_stage(cfg)


def assert_artifacts(prefix, golden_prefix, final):
    for ext in ("path", "tsv", "agp", "fa"):
        assert filecmp.cmp(
            f"{prefix}.trimmed_scafs.{ext}",
            f"{golden_prefix}.trimmed_scafs.{ext}",
            shallow=False,
        ), f"trimmed_scafs.{ext} mismatch"
    assert filecmp.cmp(
        os.path.realpath(final), f"{golden_prefix}.ntLink.scaffolds.fa",
        shallow=False,
    ), "final scaffolds mismatch"


def test_overlap_trim_scaffolds_4_goldens(golden_dir, tmp_path, monkeypatch):
    # goldens were produced with the default merge_gap=0
    cfg, final = run_case(
        tmp_path, monkeypatch, "scaffolds_4.fa", "long_reads_4.fa.gz", 40, 100, 0
    )
    prefix = cfg.resolved_prefix()
    assert_artifacts(prefix, os.path.join(golden_dir, prefix), final)


def test_overlap_trim_scaffolds_4_merge_gap(golden_dir, tmp_path, monkeypatch):
    # reference test_4 scenario: merge_gap=20
    cfg, final = run_case(
        tmp_path, monkeypatch, "scaffolds_4.fa", "long_reads_4.fa.gz", 40, 100, 20
    )
    prefix = cfg.resolved_prefix()
    with open(f"{prefix}.trimmed_scafs.path") as fh:
        got = [line.rstrip("\n").split("\t")[1] for line in fh]
    assert got == ["scaf3- 21N scaf4+", "scaf1+ 21N scaf2+"]
    # trim coordinates are independent of merge_gap: fa still byte-identical
    assert filecmp.cmp(
        f"{prefix}.trimmed_scafs.fa",
        os.path.join(golden_dir, f"{prefix}.trimmed_scafs.fa"),
        shallow=False,
    )


@pytest.mark.parametrize(
    "target,reads,k,w",
    [
        ("scaffolds_1.fa", "long_reads_1.fa", 32, 250),
        ("scaffolds_2.fa", "long_reads_2.fq.gz", 32, 100),
        ("scaffolds_3.fa", "long_reads_3.fa.gz", 24, 250),
    ],
)
def test_overlap_noop_goldens(golden_dir, tmp_path, monkeypatch, target, reads, k, w):
    cfg, final = run_case(tmp_path, monkeypatch, target, reads, k, w, 0)
    prefix = cfg.resolved_prefix()
    assert_artifacts(prefix, os.path.join(golden_dir, prefix), final)


def test_overlap_stage_memory_is_bounded(tmp_path, monkeypatch):
    """overlap_stage streams the assembly (ntlink_filter_sequences'
    purpose): peak allocations scale with the largest contig, not the
    assembly — doubling the contig count leaves the peak flat."""
    import tracemalloc

    import numpy as np

    from ntlink_jax.config import ScaffoldConfig
    from ntlink_jax.graphio import EdgeAttr, ScaffoldGraph, write_dot
    from ntlink_jax.overlap import overlap_stage

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    bases = np.array(list("ACGT"))
    clen = 120_000

    def run(n_contigs):
        d = tmp_path / f"n{n_contigs}"
        d.mkdir()
        monkeypatch.chdir(d)
        with open("target.fa", "w") as fh:
            for i in range(n_contigs):
                fh.write(
                    f">c{i}\n{''.join(bases[rng.integers(0, 4, clen)])}\n"
                )
        g = ScaffoldGraph()
        for i in range(n_contigs):
            g.add_node(f"c{i}+", clen)
            g.add_node(f"c{i}-", clen)
        g.add_edge("c0+", "c1+", EdgeAttr(d=-40, n=5))
        g.add_edge("c1-", "c0-", EdgeAttr(d=-40, n=5))
        write_dot(g, "graph.dot", None)
        with open("stitch.path", "w") as fh:
            fh.write("ntLink_0\tc0+ 1N c1+\n")
        cfg = ScaffoldConfig(target="target.fa", reads=["r.fa"], k=32, w=100)
        tracemalloc.start()
        overlap_stage(cfg, "graph.dot", "stitch.path")
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        return peak

    small = run(4)
    big = run(32)  # 8x the assembly, same largest contig
    assert big < 1.5 * small, (small, big)


def test_verbose_minimizer_graph_dump(ref_tests_dir, tmp_path, monkeypatch):
    """v=1 emits the reference's per-pair minimizer-graph DOT
    (ntlink_overlap_sequences.py:204-244): one graph block per overlapping
    join, node labels carrying (contig, position) sightings."""
    import re

    from ntlink_jax.config import ScaffoldConfig
    from ntlink_jax.pipeline import scaffold_stage

    for f in ("scaffolds_4.fa", "long_reads_4.fa.gz"):
        shutil.copy(os.path.join(ref_tests_dir, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target="scaffolds_4.fa", reads=["long_reads_4.fa.gz"], k=40, w=100,
        z=1000, overlap=True, merge_gap=0, backend="numpy", v=1,
    )
    scaffold_stage(cfg)
    mx_dot = f"{cfg.resolved_prefix()}.mx.dot"
    assert os.path.exists(mx_dot)
    text = open(mx_dot).read()
    assert text.count("graph G {") >= 1
    # node labels carry per-contig sightings: ('ctg', pos)
    assert re.search(r'\[label=".*\n\(\'\S+\', \d+\)', text)
    assert "color=lightgrey" in text
