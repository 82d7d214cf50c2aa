"""Device mapping path parity: full pair stage via the JAX backend (sharded
over the virtual 8-device CPU mesh) must match the NumPy path bit-for-bit."""
import filecmp
import os
import shutil

import jax

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import pair_stage

from conftest import REF_TESTS_DIR


def test_pair_stage_jax_backend_matches_numpy(ref_tests_dir, tmp_path, monkeypatch):
    assert len(jax.devices()) == 8  # virtual CPU mesh from conftest
    for f in ("scaffolds_1.fa", "long_reads_1.fa"):
        shutil.copy(os.path.join(ref_tests_dir, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)

    outputs = {}
    for backend in ("numpy", "jax"):
        os.makedirs(backend)
        shutil.copy("scaffolds_1.fa", f"{backend}/scaffolds_1.fa")
        shutil.copy("long_reads_1.fa", f"{backend}/long_reads_1.fa")
        monkeypatch.chdir(tmp_path / backend)
        cfg = ScaffoldConfig(
            target="scaffolds_1.fa", reads=["long_reads_1.fa"], k=32, w=250,
            z=1000, pairs_tsv=True, backend=backend, batch_bases=2_000_000,
        )
        pair_stage(cfg)
        outputs[backend] = tmp_path / backend
        monkeypatch.chdir(tmp_path)

    prefix = "scaffolds_1.fa.k32.w250.z1000"
    for artifact in (
        f"{prefix}.verbose_mapping.tsv",
        f"{prefix}.pairs.tsv",
        f"{prefix}.n1.scaffold.dot",
    ):
        assert filecmp.cmp(
            outputs["numpy"] / artifact, outputs["jax"] / artifact, shallow=False
        ), artifact


def test_pair_stage_runs_only_matches(ref_tests_dir, tmp_path, monkeypatch):
    """verbose=False engages the O(runs) D2H payload (device chaining +
    run summaries on-chip; C-worker chain_batch rows on host legs). The
    DOT and pairs.tsv artifacts must be byte-identical across the numpy
    (anchors + consumer chaining), jax (runs-only device payload), and
    hybrid (both legs runs-only) backends."""
    for f in ("scaffolds_1.fa", "long_reads_1.fa"):
        shutil.copy(os.path.join(ref_tests_dir, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)

    outputs = {}
    for backend in ("numpy", "jax", "hybrid"):
        os.makedirs(backend)
        shutil.copy("scaffolds_1.fa", f"{backend}/scaffolds_1.fa")
        shutil.copy("long_reads_1.fa", f"{backend}/long_reads_1.fa")
        monkeypatch.chdir(tmp_path / backend)
        cfg = ScaffoldConfig(
            target="scaffolds_1.fa", reads=["long_reads_1.fa"], k=32, w=250,
            z=1000, pairs_tsv=True, verbose=False, backend=backend,
            batch_bases=2_000_000,
        )
        pair_stage(cfg)
        outputs[backend] = tmp_path / backend
        monkeypatch.chdir(tmp_path)

    prefix = "scaffolds_1.fa.k32.w250.z1000"
    for artifact in (f"{prefix}.pairs.tsv", f"{prefix}.n1.scaffold.dot"):
        for backend in ("jax", "hybrid"):
            assert filecmp.cmp(
                outputs["numpy"] / artifact, outputs[backend] / artifact,
                shallow=False,
            ), (artifact, backend)
        # verbose off must mean no verbose artifact
        assert not os.path.exists(
            outputs["jax"] / f"{prefix}.verbose_mapping.tsv"
        )


def test_runs_only_mapper_rejects_verbose(tmp_path, monkeypatch):
    """A runs_only mapper reused for a verbose-rendering map_reads call
    must fail loudly (its payload has no per-anchor data), not silently
    write a wrong artifact."""
    import numpy as np
    import pytest

    from ntlink_jax import pipeline
    from ntlink_jax.index import ContigIndex
    from ntlink_jax.device_map import DeviceMapper
    from ntlink_jax.native import chain_module
    from ntlink_jax.ops import nthash_np

    if chain_module() is None:
        pytest.skip("native chain module not built")
    rng = np.random.default_rng(7)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 5000))
    index = ContigIndex.from_sketches(
        [("c0", nthash_np.sketch_sequence(seq, 32, 100))]
    )
    lengths = {"c0": len(seq)}
    dm = DeviceMapper(
        index, 32, 100, with_hashes=False,
        prechain=(np.array([len(seq)], np.int32), 1000),
        runs_only=True,
    )
    assert dm.runs_only
    reads = tmp_path / "r.fa"
    reads.write_text(f">r0\n{seq[:2000]}\n")
    cfg = pipeline.ScaffoldConfig(
        k=32, w=100, z=1000, reads=[str(reads)]
    )
    with pytest.raises(ValueError, match="runs_only"):
        pipeline.map_reads(
            cfg, index, lengths, str(tmp_path / "v.tsv"), None, mapper=dm
        )


def test_dryrun_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_scaffold_e2e_jax_backend(golden_dir, tmp_path, monkeypatch):
    """Full scaffold flow (incl. overlap trim) through the device backend:
    byte-exact final FASTA vs golden."""
    import filecmp

    from ntlink_jax.pipeline import scaffold_stage

    for f in ("scaffolds_4.fa", "long_reads_4.fa.gz"):
        shutil.copy(os.path.join(REF_TESTS_DIR, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target="scaffolds_4.fa", reads=["long_reads_4.fa.gz"], k=40, w=100,
        z=1000, overlap=True, merge_gap=0, backend="jax",
        batch_bases=2_000_000,
    )
    final = scaffold_stage(cfg)
    assert filecmp.cmp(
        os.path.realpath(final),
        os.path.join(golden_dir, "scaffolds_4.fa.k40.w100.z1000.ntLink.scaffolds.fa"),
        shallow=False,
    )
