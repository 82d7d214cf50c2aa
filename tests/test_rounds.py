"""Rounds + liftover smoke tests (reference test_6 analogue)."""
import os
import shutil

import pytest

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import run_rounds



@pytest.mark.parametrize("gap_fill", [False, True])
def test_rounds(ref_tests_dir, tmp_path, monkeypatch, gap_fill):
    shutil.copy(os.path.join(ref_tests_dir, "scaffolds_1.fa"), tmp_path / "scaffolds_1.fa")
    shutil.copy(os.path.join(ref_tests_dir, "long_reads_1.fa"), tmp_path / "long_reads_1.fa")
    monkeypatch.chdir(tmp_path)
    k = 32 if gap_fill else 33
    cfg = ScaffoldConfig(
        target="scaffolds_1.fa", reads=["long_reads_1.fa"], k=k, w=200,
        z=1000, gap_k=35, gap_w=10, backend="numpy",
    )
    final = run_rounds(cfg, rounds=5 if gap_fill else 3, gap_fill=gap_fill)
    assert os.path.exists(final)
    # final assembly should contain the joined scaffold (2 contigs -> 1 path)
    headers = [l for l in open(os.path.realpath(final)) if l.startswith(">")]
    assert len(headers) == 1
    # round >=2 must have used the liftover checkpoint, not re-mapping
    suffix = "ntLink.gap_fill" if gap_fill else "ntLink"
    ckpt = f"scaffolds_1.fa.k{k}.w200.z1000.{suffix}.fa.k{k}.w200.z1000.verbose_mapping.tsv"
    assert os.path.exists(ckpt)


def test_rounds_via_cli(ref_tests_dir, tmp_path, monkeypatch):
    """`ntLink_rounds run_rounds ... rounds=N` must accept the rounds knob
    (driver-level parameter, not a config field — regression test)."""
    from ntlink_jax.cli import main

    shutil.copy(
        os.path.join(ref_tests_dir, "scaffolds_1.fa"), tmp_path / "s.fa"
    )
    shutil.copy(
        os.path.join(ref_tests_dir, "long_reads_1.fa"), tmp_path / "r.fa"
    )
    monkeypatch.chdir(tmp_path)
    rc = main(
        [
            "run_rounds", "target=s.fa", "reads=r.fa", "rounds=2",
            "k=32", "w=250", "z=1000", "backend=numpy",
        ]
    )
    assert rc == 0
    assert os.path.exists("s.fa.k32.w250.z1000.ntLink.2rounds.fa")
