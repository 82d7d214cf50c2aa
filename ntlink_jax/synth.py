"""Seeded synthetic scaffolding workloads (no files from outside the repo).

A random genome is cut into `n_contigs` contigs of `contig_len` bases, with
`gap` unassembled bases between neighbours, so every pair of neighbours is
a true join. Reads of `read_len` bases are drawn from the whole genome, with
`err` substitutions per base and half of them reverse-complemented, so
reads that span a gap carry the evidence for its join. `gapped=True` also
writes N runs into each contig, as in a draft from an earlier scaffolding
round (the input of rounds >= 2); the reads still come from the gapless
genome.

Presets used by the repo's scripts (contigs x length, reads):
    100 Mb (C. elegans-sized): 250 x 400 kb, 30,000 x 12 kb reads
    human 3 Gb:                750 x 4 Mb, 2,500,000 x 12 kb reads
"""
from __future__ import annotations

import numpy as np

_ASCII = np.frombuffer(b"ACGT", np.uint8)


def _complement_table() -> np.ndarray:
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    return comp


def write_dataset(reads_path: str, targets: dict, n_contigs: int,
                  contig_len: int, n_reads: int, read_len: int = 12_000,
                  gap: int = 500, err: float = 0.04, seed: int = 5) -> None:
    """Write the reads FASTA and one draft FASTA per `targets` entry
    ({path: gapped}); every draft and the reads come from the same genome.
    Vectorized: the 3 Gb preset writes ~33 GB of FASTA."""
    rng = np.random.default_rng(seed)
    total_len = n_contigs * contig_len + (n_contigs - 1) * gap
    genome = _ASCII[rng.integers(0, 4, total_len, dtype=np.uint8)]
    for path, gapped in targets.items():
        n_rng = np.random.default_rng(seed + 1)  # N runs of a gapped draft
        with open(path, "wb") as fh:
            for i in range(n_contigs):
                off = i * (contig_len + gap)
                ctg = genome[off : off + contig_len]
                if gapped:
                    ctg = ctg.copy()
                    for _ in range(3):
                        g0 = int(n_rng.integers(contig_len // 10, contig_len - 1000))
                        ctg[g0 : g0 + int(n_rng.integers(100, 800))] = ord("N")
                fh.write(b">c%d\n" % i)
                fh.write(ctg.tobytes())
                fh.write(b"\n")

    comp = _complement_table()
    chunk = 2048  # gather index matrix is chunk x read_len int64
    err_n = int(read_len * err)
    with open(reads_path, "wb") as fh:
        for base_r in range(0, n_reads, chunk):
            n = min(chunk, n_reads - base_r)
            starts = rng.integers(0, total_len - read_len, n)
            mat = genome[starts[:, None] + np.arange(read_len)]
            rows = np.repeat(np.arange(n), err_n)
            cols = rng.integers(0, read_len, n * err_n)
            mat[rows, cols] = _ASCII[rng.integers(0, 4, n * err_n, dtype=np.uint8)]
            flip = rng.random(n) < 0.5
            mat[flip] = comp[mat[flip][:, ::-1]]
            for j in range(n):
                fh.write(b">r%d\n" % (base_r + j))
                fh.write(mat[j].tobytes())
                fh.write(b"\n")
