"""Sketch kernel parity vs the reference's committed golden indexlr TSVs."""
import os

import pytest

from ntlink_jax.ops import nthash_np
from ntlink_jax.seqio import stream_fastx
from ntlink_jax.sketch import format_minimizers

from conftest import GOLDEN_DIR

GOLDEN_TSVS = [
    ("scaffolds_1.fa", 32, 250),
    ("scaffolds_2.fa", 32, 100),
    ("scaffolds_3.fa", 24, 250),
    ("scaffolds_4.fa", 40, 100),
]


def load_golden(fa, k, w):
    path = os.path.join(GOLDEN_DIR, f"{fa}.k{k}.w{w}.tsv")
    golden = {}
    with open(path) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            golden[parts[0]] = parts[1] if len(parts) > 1 else ""
    return golden


@pytest.mark.parametrize("fa,k,w", GOLDEN_TSVS)
def test_sketch_matches_golden_tsv(ref_tests_dir, fa, k, w):
    golden = load_golden(fa, k, w)
    for rec in stream_fastx(os.path.join(ref_tests_dir, fa)):
        mins = nthash_np.sketch_sequence(rec.seq, k, w)
        assert format_minimizers(mins) == golden[rec.name], rec.name


def test_srol_period():
    import numpy as np

    x = np.uint64(0x123456789ABCDEF0)
    assert nthash_np.srol(x, 1023) == x
    assert nthash_np.srol(nthash_np.srol(x, 5), 7) == nthash_np.srol(x, 12)


def test_n_handling_splits_windows():
    # a sequence with an N: k-mers covering the N are skipped entirely
    seq = "ACGTACGTACGTACGTNACGTACGTACGTACGT"
    h = nthash_np.hash_kmers(nthash_np.encode(seq), 8)
    n_pos = seq.index("N")
    for i, v in enumerate(h.valid):
        overlaps_n = i <= n_pos <= i + 7
        assert v != overlaps_n


def test_short_sequence_empty_sketch():
    assert len(nthash_np.sketch_sequence("ACGT", 8, 5)) == 0
    # fewer valid kmers than w -> no windows
    assert len(nthash_np.sketch_sequence("ACGTACGTAC", 8, 5)) == 0
