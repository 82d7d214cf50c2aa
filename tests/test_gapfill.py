"""Gap-fill stage parity: byte-exact gap-filled FASTA (reference test_5/8)."""
import filecmp
import os
import shutil

import pytest

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import run_scaffold

from conftest import REF_TESTS_DIR

GOLDEN_FA = "scaffolds_1.fa.k32.w250.z1000.ntLink.scaffolds.gap_fill.fa"


@pytest.mark.parametrize(
    "reads", [["long_reads_1.fa"], ["long_reads_1-1.fa", "long_reads_1-2.fa"]]
)
def test_gap_fill(golden_dir, tmp_path, monkeypatch, reads):
    shutil.copy(os.path.join(REF_TESTS_DIR, "scaffolds_1.fa"), tmp_path / "scaffolds_1.fa")
    for r in reads:
        shutil.copy(os.path.join(REF_TESTS_DIR, r), tmp_path / r)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target="scaffolds_1.fa", reads=reads, k=32, w=250, z=1000,
        gap_k=35, gap_w=10, backend="numpy",
    )
    out = run_scaffold(cfg, gap_fill=True)
    assert filecmp.cmp(out, os.path.join(golden_dir, GOLDEN_FA), shallow=False)
    assert os.path.realpath(cfg.out_scaffolds()).endswith("gap_fill.fa")
    assert os.path.exists(out + ".agp")
