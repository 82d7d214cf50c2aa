"""BASELINE config-3 scenario: sensitive mode + dense sketches (w=50, z=500).

No reference goldens exist for this configuration; assert the pipeline runs
end to end, produces the expected artifact set, and that sensitive mode's
mapping superset still yields the known-correct join for scaffolds_1.
"""
import os
import shutil

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import scaffold_stage



def test_sensitive_dense_sketch_e2e(ref_tests_dir, tmp_path, monkeypatch):
    for f in ("scaffolds_1.fa", "long_reads_1.fa"):
        shutil.copy(os.path.join(ref_tests_dir, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target="scaffolds_1.fa", reads=["long_reads_1.fa"], k=32, w=50,
        z=500, sensitive=True, repeats=True, backend="numpy",
    )
    final = scaffold_stage(cfg)
    prefix = cfg.resolved_prefix()
    assert os.path.exists(f"{prefix}.n1.scaffold.dot")
    with open(f"{prefix}.stitch.path") as fh:
        paths = [l.rstrip("\n").split("\t")[1] for l in fh]
    # denser sketch, sensitive chaining: the two contigs must still join
    assert len(paths) == 1
    tokens = paths[0].split(" ")
    assert {tokens[0][:-1], tokens[2][:-1]} == {"188266", "189231"}
    assert os.path.exists(os.path.realpath(final))
