"""Robustness edge cases: empty graphs, unmappable reads, tiny inputs."""
import os
import random
import shutil

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.pipeline import run_scaffold, scaffold_stage
from ntlink_jax.seqio import stream_fastx



def write_fasta(path, records):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")


def random_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def test_no_mappable_reads_passthrough(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = random.Random(1)
    contigs = [("c1", random_seq(rng, 3000)), ("c2", random_seq(rng, 2500))]
    write_fasta("target.fa", contigs)
    # reads unrelated to the target: no anchors, empty graph
    write_fasta("reads.fa", [("r1", random_seq(rng, 2000))])
    cfg = ScaffoldConfig(
        target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000,
        backend="numpy",
    )
    final = scaffold_stage(cfg)
    out = {r.name: r.seq for r in stream_fastx(os.path.realpath(final))}
    # all contigs pass through unjoined
    assert {n.split()[0] for n in out} == {"c1", "c2"}
    assert sorted(out.values()) == sorted(s for _, s in contigs)


def test_contigs_shorter_than_k(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = random.Random(2)
    write_fasta("target.fa", [("tiny", "ACGT"), ("c1", random_seq(rng, 3000))])
    write_fasta("reads.fa", [("r1", random_seq(rng, 1500))])
    cfg = ScaffoldConfig(
        target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000,
        backend="numpy",
    )
    final = scaffold_stage(cfg)
    out = {r.name.split()[0] for r in stream_fastx(os.path.realpath(final))}
    assert out == {"tiny", "c1"}


def test_gap_fill_with_no_fillable_gaps(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = random.Random(3)
    write_fasta("target.fa", [("c1", random_seq(rng, 3000))])
    write_fasta("reads.fa", [("r1", random_seq(rng, 1500))])
    cfg = ScaffoldConfig(
        target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000,
        backend="numpy",
    )
    out = run_scaffold(cfg, gap_fill=True)
    assert os.path.exists(out)
    assert os.path.exists(out + ".agp")


def test_empty_reads_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = random.Random(4)
    write_fasta("target.fa", [("c1", random_seq(rng, 3000))])
    open("reads.fa", "w").close()
    cfg = ScaffoldConfig(
        target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000,
        backend="numpy",
    )
    final = scaffold_stage(cfg)
    assert os.path.exists(os.path.realpath(final))


def test_cli_drop_in(ref_tests_dir, tmp_path, monkeypatch):
    import subprocess

    for f in ("scaffolds_1.fa", "long_reads_1.fa"):
        shutil.copy(os.path.join(ref_tests_dir, f), tmp_path / f)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [
            "/root/repo/ntLink", "scaffold",
            "target=scaffolds_1.fa", "reads=long_reads_1.fa",
            "w=250", "backend=numpy", "-B",
        ],
        cwd=tmp_path,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "scaffolds_1.fa.k32.w250.z1000.ntLink.scaffolds.fa").exists()


def test_non_conservative_mode_e2e(ref_tests_dir, tmp_path, monkeypatch):
    # reference: conservative=False stitches across the n-sweep outputs
    for f in ("scaffolds_3.fa", "long_reads_3.fa.gz"):
        shutil.copy(os.path.join(ref_tests_dir, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(
        target="scaffolds_3.fa", reads=["long_reads_3.fa.gz"], k=24, w=250,
        z=1000, conservative=False, backend="numpy",
    )
    final = scaffold_stage(cfg)
    with open(f"{cfg.resolved_prefix()}.stitch.path") as fh:
        paths = [l.rstrip("\n").split("\t")[1] for l in fh]
    # same layout as conservative on this clean dataset
    assert sorted(paths) == sorted(
        [
            "189459+ 71N 183836- 433N 182169- 1315N 190964+",
            "188266+ 4579N 189231-",
        ]
    )
    assert os.path.exists(os.path.realpath(final))


def test_native_chainer_many_distinct_contigs():
    """Reads hitting hundreds of distinct contigs chain exactly (the old
    fixed-size scratch raised OverflowError; scratch is dynamic now)."""
    import numpy as np

    from ntlink_jax.mapping import AnchorHit, chain_read_hits
    from ntlink_jax.native import chain_module

    mod = chain_module()
    if mod is None:
        return
    n = 600
    clen = np.full(n, 5000, np.int32)
    names = [f"c{i}" for i in range(n)]
    lengths = {names[i]: 5000 for i in range(n)}
    ch = mod.Chainer(clen, names)
    rng = np.random.default_rng(7)
    cids = rng.integers(0, n, size=n).astype(np.int32)
    cpos = rng.integers(0, 5000, size=n).astype(np.int32)
    rpos = np.sort(rng.integers(0, 4000, size=n)).astype(np.int32)
    sbits = rng.integers(0, 4, size=n).astype(np.int32)
    runs_raw, _ = ch.chain(cids, cpos, rpos, sbits, n, 4000, 32, 100, 0, 0.0, None)
    hits = [
        (names[c], AnchorHit(0, int(p), "+" if b & 1 else "-", int(r),
                             "+" if b & 2 else "-"))
        for c, p, r, b in zip(cids, cpos, rpos, sbits)
    ]
    expected = chain_read_hits(hits, 4000, lengths, k=32, z=100, x=0.0)
    assert len(runs_raw) == len(expected)
    for got, run in zip(runs_raw, expected):
        assert names[got[0]] == run.contig and got[1] == run.hit_count


def test_unknown_parameter_fails_loudly():
    import pytest

    from ntlink_jax.cli import build_config

    with pytest.raises(SystemExit):
        build_config({"bogus_knob": "1"})


def test_driver_keys_rejected_for_wrong_target():
    """Driver-level knobs are only accepted where they mean something:
    rounds= for run_rounds*, agp=/mappings=/out= for liftover — anywhere
    else they must fail loudly, not silently no-op."""
    import pytest

    from ntlink_jax.cli import build_config

    # scaffold-style call (no driver keys allowed)
    for key in ("out", "agp", "mappings", "rounds"):
        with pytest.raises(SystemExit):
            build_config({key: "x"}, allowed_driver=frozenset())
    # rounds allowed for the rounds targets, but must be an integer
    build_config({"rounds": "3"}, allowed_driver=frozenset(("rounds",)))
    with pytest.raises(SystemExit):
        build_config({"rounds": "abc"}, allowed_driver=frozenset(("rounds",)))


def test_default_idx_shards_divides_device_count():
    from ntlink_jax.device_map import default_idx_shards

    assert default_idx_shards(1) == 1
    assert default_idx_shards(2) == 2
    assert default_idx_shards(3) == 1
    assert default_idx_shards(4) == 4
    assert default_idx_shards(6) == 2
    assert default_idx_shards(8) == 4
    assert default_idx_shards(12) == 4
    for n in range(1, 33):
        s = default_idx_shards(n)
        assert n % s == 0 and (s & (s - 1)) == 0
