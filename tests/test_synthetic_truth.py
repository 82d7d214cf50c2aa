"""Whole-engine correctness against synthetic ground truth.

A random genome is split into contigs separated by known gaps; reads sampled
across the junctions must drive the engine to reassemble the original contig
order/orientation with accurate gap estimates — independent of any reference
goldens.
"""
import os

import numpy as np

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import run_scaffold

BASES = np.array(list("ACGT"))


def make_genome(rng, n_contigs=6, contig_len=400_000, gap=500):
    pieces, contigs = [], []
    for i in range(n_contigs):
        seq = "".join(BASES[rng.integers(0, 4, contig_len)])
        contigs.append((f"contig{i}", seq))
        pieces.append(seq)
        if i + 1 < n_contigs:
            pieces.append("".join(BASES[rng.integers(0, 4, gap)]))
    return "".join(pieces), contigs


def sample_reads(rng, genome, n_reads=800, read_len=12_000, err=0.03):
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for r in range(n_reads):
        start = int(rng.integers(0, len(genome) - read_len))
        arr = np.frombuffer(
            genome[start : start + read_len].encode(), dtype=np.uint8
        ).copy()
        n_err = int(read_len * err)
        pos = rng.integers(0, read_len, n_err)
        arr[pos] = BASES[rng.integers(0, 4, n_err)].astype("S1").view(np.uint8)
        seq = arr.tobytes().decode()
        if rng.random() < 0.5:
            seq = seq.translate(comp)[::-1]
        reads.append((f"r{r}", seq))
    return reads


def test_reassembles_synthetic_genome(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(11)
    genome, contigs = make_genome(rng)
    with open("target.fa", "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n{seq}\n")
    with open("reads.fa", "w") as fh:
        for name, seq in sample_reads(rng, genome):
            fh.write(f">{name}\n{seq}\n")

    cfg = ScaffoldConfig(
        target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000,
        backend="numpy",
    )
    final = run_scaffold(cfg, gap_fill=False)
    prefix = cfg.resolved_prefix()

    with open(f"{prefix}.stitch.path") as fh:
        paths = [line.rstrip("\n").split("\t")[1] for line in fh]
    assert len(paths) == 1, paths
    tokens = paths[0].split(" ")
    names = [t[:-1] for t in tokens[::2]]
    oris = [t[-1] for t in tokens[::2]]
    gaps = [int(t[:-1]) for t in tokens[1::2]]
    expected = [f"contig{i}" for i in range(len(contigs))]
    if names != expected:
        names, oris = names[::-1], ["-" if o == "+" else "+" for o in oris[::-1]]
    assert names == expected
    assert len(set(oris)) == 1  # consistent orientation through the chain
    for g in gaps:
        assert 200 <= g <= 800, f"gap estimate {g} far from truth 500"

    # final fasta: one scaffold spanning all contigs
    headers = [l for l in open(os.path.realpath(final)) if l.startswith(">")]
    assert len(headers) == 1


def test_gap_fill_recovers_gap_sequence(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(12)
    genome, contigs = make_genome(rng, n_contigs=3, contig_len=300_000)
    with open("target.fa", "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n{seq}\n")
    with open("reads.fa", "w") as fh:
        for name, seq in sample_reads(rng, genome, n_reads=500):
            fh.write(f">{name}\n{seq}\n")

    cfg = ScaffoldConfig(
        target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000,
        backend="numpy",
    )
    out = run_scaffold(cfg, gap_fill=True)
    seqs = []
    seq = None
    for line in open(out):
        if line.startswith(">"):
            if seq is not None:
                seqs.append(seq)
            seq = ""
        else:
            seq += line.strip()
    seqs.append(seq)
    big = max(seqs, key=len)
    # both gaps patched with read-derived sequence: scaffold length close to
    # the genome, and only a tiny N fraction left
    assert abs(len(big) - len(genome)) < 0.02 * len(genome)
    assert big.upper().count("N") < 0.01 * len(big)
