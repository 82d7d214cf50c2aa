"""Gap-fill flag coverage: soft_mask lowercases fills; stringent runs."""
import os
import re
import shutil

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import run_scaffold

from conftest import REF_TESTS_DIR


def _run(tmp_path, monkeypatch, **kw):
    for f in ("scaffolds_1.fa", "long_reads_1.fa"):
        shutil.copy(os.path.join(REF_TESTS_DIR, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target="scaffolds_1.fa", reads=["long_reads_1.fa"], k=32, w=250,
        z=1000, gap_k=35, gap_w=10, backend="numpy", **kw,
    )
    out = run_scaffold(cfg, gap_fill=True)
    recs = {}
    name = None
    for line in open(out):
        if line.startswith(">"):
            name = line[1:].strip()
            recs[name] = ""
        else:
            recs[name] += line.strip()
    return recs


def test_soft_mask_lowercases_fill(golden_dir, tmp_path, monkeypatch):
    recs = _run(tmp_path, monkeypatch, soft_mask=True)
    seq = recs["ntLink_0"]
    golden = {}
    name = None
    for line in open(
        os.path.join(golden_dir, "scaffolds_1.fa.k32.w250.z1000.ntLink.scaffolds.gap_fill.fa")
    ):
        if line.startswith(">"):
            name = line[1:].strip()
            golden[name] = ""
        else:
            golden[name] += line.strip()
    gold = golden["ntLink_0"]
    # same sequence modulo case; a substantial lowercase run marks the fill
    assert seq.upper() == gold.upper()
    runs = [m for m in re.finditer(r"[acgt]{100,}", seq)]
    assert runs, "soft-masked fill region missing"


def test_stringent_mode_runs(ref_tests_dir, tmp_path, monkeypatch):
    recs = _run(tmp_path, monkeypatch, stringent=True)
    assert "ntLink_0" in recs and len(recs["ntLink_0"]) > 80_000
