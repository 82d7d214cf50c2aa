"""PAF output through the device (JAX) backend matches the NumPy path."""
import filecmp
import os
import shutil

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import pair_stage



def test_paf_device_backend(ref_tests_dir, tmp_path, monkeypatch):
    for backend in ("numpy", "jax"):
        d = tmp_path / backend
        d.mkdir()
        for f in ("scaffolds_4.fa", "long_reads_4_top5.fa"):
            shutil.copy(os.path.join(ref_tests_dir, f), d / f)
        monkeypatch.chdir(d)
        cfg = ScaffoldConfig(
            target="scaffolds_4.fa", reads=["long_reads_4_top5.fa"], k=40,
            w=100, z=1000, paf=True, backend=backend,
        )
        pair_stage(cfg)
        monkeypatch.chdir(tmp_path)
    prefix = "scaffolds_4.fa.k40.w100.z1000"
    assert filecmp.cmp(
        tmp_path / "numpy" / f"{prefix}.paf",
        tmp_path / "jax" / f"{prefix}.paf",
        shallow=False,
    )


def test_repeats_device_backend(ref_tests_dir, tmp_path, monkeypatch):
    """repeats=True through the native batch path (vectorized repeat filter
    + C chaining) == the NumPy per-hit reference path, byte for byte."""
    for backend in ("numpy", "jax"):
        d = tmp_path / backend
        d.mkdir()
        for f in ("scaffolds_2.fa", "long_reads_2.fq.gz"):
            shutil.copy(os.path.join(ref_tests_dir, f), d / f)
        monkeypatch.chdir(d)
        cfg = ScaffoldConfig(
            target="scaffolds_2.fa", reads=["long_reads_2.fq.gz"], k=32,
            w=100, z=1000, repeats=True, paf=True, pairs_tsv=True,
            backend=backend,
        )
        pair_stage(cfg)
        monkeypatch.chdir(tmp_path)
    prefix = "scaffolds_2.fa.k32.w100.z1000"
    for artifact in (
        f"{prefix}.verbose_mapping.tsv",
        f"{prefix}.paf",
        f"{prefix}.pairs.tsv",
        f"{prefix}.n1.scaffold.dot",
    ):
        assert filecmp.cmp(
            tmp_path / "numpy" / artifact,
            tmp_path / "jax" / artifact,
            shallow=False,
        ), artifact


def test_explicit_checkpoint(ref_tests_dir, tmp_path, monkeypatch):
    for f in ("scaffolds_1.fa", "long_reads_1.fa"):
        shutil.copy(os.path.join(ref_tests_dir, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target="scaffolds_1.fa", reads=["long_reads_1.fa"], k=32, w=250,
        z=1000, backend="numpy",
    )
    pair_stage(cfg)
    prefix = cfg.resolved_prefix()
    os.rename(f"{prefix}.verbose_mapping.tsv", "ckpt.tsv")
    dot1 = open(f"{prefix}.n1.scaffold.dot").read()
    os.unlink(f"{prefix}.n1.scaffold.dot")
    cfg2 = ScaffoldConfig(
        target="scaffolds_1.fa", reads=["long_reads_1.fa"], k=32, w=250,
        z=1000, backend="numpy", checkpoint="ckpt.tsv",
    )
    pair_stage(cfg2)
    dot2 = open(f"{prefix}.n1.scaffold.dot").read()
    assert dot1 == dot2
