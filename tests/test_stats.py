"""abyss-fac-equivalent stats parity vs the reference's golden tables."""
import os

import pytest

from ntlink_jax.seqio import stream_fastx
from ntlink_jax.stats import fac_row, non_n_length


CASES = [
    "scaffolds_1.fa.k32.w250.z1000.ntLink.scaffolds.fa",
    "scaffolds_2.fa.k32.w100.z1000.ntLink.scaffolds.fa",
    "scaffolds_3.fa.k24.w250.z1000.ntLink.scaffolds.fa",
    "scaffolds_4.fa.k40.w100.z1000.ntLink.scaffolds.fa",
]


@pytest.mark.parametrize("fname", CASES)
def test_fac_matches_abyssfac_golden(golden_dir, fname):
    fa = os.path.join(golden_dir, fname)
    lengths = [non_n_length(r.seq) for r in stream_fastx(fa)]
    got = fac_row(lengths, fname)
    with open(fa + ".abyssfac.tsv") as fh:
        fh.readline()
        golden = fh.readline().rstrip("\n")
    assert got == golden
