"""Liftover output-neutrality: a round-2 run fed by the lifted checkpoint
must produce byte-identical artifacts (dot / stitch.path / final FASTA) to a
round-2 run that freshly re-maps the reads against the round-1 output.

Reference contract: ntLink_rounds:122-145 treats the lifted mapping purely
as an optimization; ntlink_pair.py:437-488 rebuilds the tally from it.
A liftover bug (wrong offsets, bad strand math, missed run merge across a
round-1 join) would surface as extra/missing pairs and diverging artifacts.
"""
import filecmp
import os
import shutil

import numpy as np
import pytest

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.liftover import liftover_mappings
from ntlink_jax.pipeline import run_scaffold

from test_synthetic_truth import make_genome, sample_reads


@pytest.fixture(scope="module")
def round1_dir(tmp_path_factory):
    """Round 1 over a two-chromosome genome: two multi-contig scaffolds."""
    d = tmp_path_factory.mktemp("round1")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        rng = np.random.default_rng(21)
        with open("target.fa", "w") as tfh, open("reads.fa", "w") as rfh:
            for chrom in range(2):
                genome, contigs = make_genome(
                    rng, n_contigs=3, contig_len=200_000, gap=400
                )
                for name, seq in contigs:
                    tfh.write(f">chr{chrom}_{name}\n{seq}\n")
                for name, seq in sample_reads(rng, genome, n_reads=300):
                    rfh.write(f">c{chrom}{name}\n{seq}\n")
        cfg = ScaffoldConfig(
            target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000,
            backend="numpy", verbose=True,
        )
        run_scaffold(cfg, gap_fill=False)
        prefix = cfg.resolved_prefix()
        # round-1 outputs under the names ntLink_rounds would link
        shutil.copy(os.path.realpath(cfg.out_scaffolds()), "round1.fa")
        shutil.copy(f"{prefix}.trimmed_scafs.agp", "round1.fa.agp")
        shutil.copy(
            f"{prefix}.verbose_mapping.tsv", "round1.fa.verbose_mapping.tsv"
        )
        # round-1 produced real joins (multi-contig scaffolds)
        headers = [l for l in open("round1.fa") if l.startswith(">")]
        assert len(headers) == 2, headers
    finally:
        os.chdir(cwd)
    return d


def _run_round2(src, dst, lifted: bool):
    os.makedirs(dst)
    for f in ("round1.fa", "round1.fa.agp", "round1.fa.verbose_mapping.tsv",
              "reads.fa"):
        shutil.copy(os.path.join(src, f), dst)
    cwd = os.getcwd()
    os.chdir(dst)
    try:
        cfg = ScaffoldConfig(
            target="round1.fa", reads=["reads.fa"], k=32, w=100, z=1000,
            backend="numpy", verbose=True,
        )
        prefix = cfg.resolved_prefix()
        if lifted:
            liftover_mappings(
                "round1.fa.verbose_mapping.tsv",
                "round1.fa.agp",
                f"{prefix}.verbose_mapping.tsv",
                cfg.k,
            )
            # the checkpoint must actually bypass mapping
            import ntlink_jax.pipeline as pl

            real_map = pl.map_reads

            def boom(*a, **k):
                raise AssertionError("lifted checkpoint was not used")

            pl.map_reads = boom
            try:
                run_scaffold(cfg, gap_fill=False)
            finally:
                pl.map_reads = real_map
        else:
            run_scaffold(cfg, gap_fill=False)
        return prefix
    finally:
        os.chdir(cwd)


def test_lifted_round2_matches_fresh_remap(round1_dir, tmp_path):
    lifted_dir = tmp_path / "lifted"
    fresh_dir = tmp_path / "fresh"
    prefix = _run_round2(round1_dir, lifted_dir, lifted=True)
    _run_round2(round1_dir, fresh_dir, lifted=False)

    for artifact in (
        f"{prefix}.n1.scaffold.dot",
        f"{prefix}.stitch.path",
        "round1.fa.k32.w100.z1000.ntLink.scaffolds.fa",
    ):
        a, b = lifted_dir / artifact, fresh_dir / artifact
        if os.path.islink(a):
            a, b = os.path.realpath(a), os.path.realpath(b)
        assert filecmp.cmp(a, b, shallow=False), artifact
