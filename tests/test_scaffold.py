"""End-to-end scaffold flow parity (overlap disabled) vs goldens."""
import filecmp
import os
import shutil

import pytest

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import scaffold_stage

from conftest import REF_TESTS_DIR

CONFIGS = [
    # (target, reads, k, w, expected stitch paths)
    ("scaffolds_1.fa", "long_reads_1.fa", 32, 250, ["188266+ 4542N 189231-"]),
    (
        "scaffolds_2.fa",
        "long_reads_2.fq.gz",
        32,
        100,
        ["189459+ 90N 183836- 449N 182169- 1294N 190964+"],
    ),
    (
        "scaffolds_3.fa",
        "long_reads_3.fa.gz",
        24,
        250,
        [
            "189459+ 71N 183836- 433N 182169- 1315N 190964+",
            "188266+ 4579N 189231-",
        ],
    ),
]


@pytest.mark.parametrize("target,reads,k,w,expected_paths", CONFIGS)
def test_scaffold_no_overlap(golden_dir, tmp_path, monkeypatch, target, reads, k, w, expected_paths):
    shutil.copy(os.path.join(REF_TESTS_DIR, target), tmp_path / target)
    shutil.copy(os.path.join(REF_TESTS_DIR, reads), tmp_path / reads)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target=target, reads=[reads], k=k, w=w, z=1000, overlap=False,
        backend="numpy",
    )
    final = scaffold_stage(cfg)
    prefix = cfg.resolved_prefix()

    with open(f"{prefix}.stitch.path") as fh:
        got = [line.rstrip("\n").split("\t")[1] for line in fh]
    assert got == expected_paths

    # byte-exact stitch.path vs golden
    golden_prefix = os.path.join(golden_dir, f"{target}.k{k}.w{w}.z1000")
    assert filecmp.cmp(
        f"{prefix}.stitch.path", f"{golden_prefix}.stitch.path", shallow=False
    ), "stitch.path mismatch"

    # final scaffolds: byte-exact vs golden (no negative gaps in these sets,
    # so overlap-trim is a no-op in the reference run that made the goldens)
    assert filecmp.cmp(
        os.path.realpath(final),
        f"{golden_prefix}.ntLink.scaffolds.fa",
        shallow=False,
    ), "final scaffolds mismatch"
