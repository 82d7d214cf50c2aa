"""Make-style incrementality: a second run reuses every fresh artifact."""
import os
import shutil

import pytest

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import scaffold_stage



def test_second_run_reuses_artifacts(ref_tests_dir, tmp_path, monkeypatch):
    for f in ("scaffolds_1.fa", "long_reads_1.fa"):
        shutil.copy(os.path.join(ref_tests_dir, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target="scaffolds_1.fa", reads=["long_reads_1.fa"], k=32, w=250,
        z=1000, backend="numpy",
    )
    final = scaffold_stage(cfg)
    prefix = cfg.resolved_prefix()
    artifacts = [
        f"{prefix}.n1.scaffold.dot",
        f"{prefix}.stitch.path",
        f"{prefix}.trimmed_scafs.fa",
        "scaffolds_1.fa.k32.w250.z1000.stitch.abyss-scaffold.fa",
    ]
    mtimes = {a: os.path.getmtime(a) for a in artifacts}

    scaffold_stage(cfg)  # second run: everything fresh
    for a in artifacts:
        assert os.path.getmtime(a) == mtimes[a], f"{a} was rebuilt"

    # touching the reads invalidates mapping and everything downstream
    os.utime("long_reads_1.fa")
    scaffold_stage(cfg)
    assert os.path.getmtime(artifacts[0]) > mtimes[artifacts[0]]


def test_killed_sketch_leaves_no_reusable_artifact(tmp_path, monkeypatch):
    """A run killed mid-sketch must not leave a TSV the next run's
    freshness check would reuse (tmp+rename write), and a legacy 0-byte
    TSV is treated as stale rather than loaded as an empty index."""
    import os

    from ntlink_jax import pipeline
    from ntlink_jax.config import ScaffoldConfig
    from ntlink_jax.sketch import sketch_fasta_to_tsv

    fa = tmp_path / "t.fa"
    fa.write_text(">c1\n" + "ACGT" * 300 + "\n")
    out = tmp_path / "t.tsv"

    class Boom(RuntimeError):
        pass

    class ExplodingBackend:
        def sketch_stream(self, named_seqs, k, w):
            raise Boom()
            yield  # pragma: no cover

    with pytest.raises(Boom):
        sketch_fasta_to_tsv(str(fa), str(out), 16, 10,
                            backend=ExplodingBackend())
    assert not out.exists()
    assert not any(p.name.startswith("t.tsv.tmp") for p in tmp_path.iterdir())

    # legacy truncated artifact: fresh mtime but zero bytes -> re-sketched
    cfg = ScaffoldConfig(target=str(fa), reads=[], k=16, w=10, backend="numpy")
    stale = tmp_path / "t.fa.k16.w10.tsv"
    stale.write_bytes(b"")
    got = pipeline.ensure_contig_sketch_tsv(cfg, 16, 10)
    assert os.path.getsize(got) > 0
