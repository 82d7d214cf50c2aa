"""One sketch form per step, the compile-cache rule, loud device errors, and
the run counters that show where the work ran."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.index import ContigIndex
from ntlink_jax.ops import nthash_np

REPO = pathlib.Path(__file__).resolve().parents[1]
K, W = 15, 10


def _index(rng, n_contigs=2, length=3000):
    seqs = {
        f"c{i}": "".join(rng.choice(list("ACGT"), size=length))
        for i in range(n_contigs)
    }
    idx = ContigIndex.from_sketches(
        (n, nthash_np.sketch_sequence(s, K, W)) for n, s in seqs.items()
    )
    return idx, seqs


def _lowered_text(variant: str) -> str:
    """StableHLO of one step variant at a small shape."""
    from ntlink_jax.device_map import DeviceMapper, _single_device_step
    from ntlink_jax.ops.sketch_jax import _sketch_step
    from ntlink_jax.parallel.mesh import make_mesh, make_sharded_mapping_step
    from ntlink_jax.parallel.sharded_index import (
        ShardedDeviceIndex,
        make_mesh_2d,
        make_sharded_index_mapping_step,
    )

    rng = np.random.default_rng(3)
    idx, seqs = _index(rng)
    clen = np.array([len(seqs[n]) for n in idx.contig_names], np.int32)
    B, L = 8, 1024
    packed = jnp.zeros((B, L // 4), jnp.uint8)
    lengths = jnp.full((B,), L, jnp.int32)
    nmask = jnp.zeros((B, L // 8), jnp.uint8)
    if variant.startswith("sketch"):
        args = (packed, lengths, K, W, L, 256)
        if variant == "sketch-nmask":
            args += (nmask,)
        return _sketch_step().lower(*args).as_text()
    if variant in ("map-runs", "map-anchors", "map-nmask"):
        dm = DeviceMapper(idx, K, W, use_mesh=False, with_hashes=False,
                          prechain=(clen, 0),
                          runs_only=variant == "map-runs")
        d = dm.didx
        args = (packed, lengths, d.t_bkt, d.t_off, dm._clen_dev, K, W, L,
                d.mask, d.max_probes, 256, False, True, True, 0,
                variant == "map-runs")
        if variant == "map-nmask":
            args += (nmask,)
        return _single_device_step().lower(*args).as_text()
    if variant == "data-mesh":
        dm = DeviceMapper(idx, K, W, use_mesh=False)
        step = make_sharded_mapping_step(
            make_mesh(), K, W, L, dm.didx.mask, dm.didx.max_probes, 256
        )
        fn = jax.jit(lambda p, l: step(p, l, dm.didx))
        return fn.lower(packed, lengths).as_text()
    sidx = ShardedDeviceIndex.from_contig_index(idx, 2)
    step = make_sharded_index_mapping_step(make_mesh_2d(2), sidx, K, W, L, 256)
    fn = jax.jit(lambda p, l: step(p, l))
    return fn.lower(packed, lengths).as_text()


@pytest.mark.parametrize(
    "variant",
    ["map-runs", "map-anchors", "map-nmask", "sketch", "sketch-nmask",
     "data-mesh", "hash-sharded"],
)
def test_step_variant_lowers_to_plain_xla(variant):
    """Every step variant lowers to plain XLA ops — no custom call, which
    is how a hand-written (Pallas, Triton, Mosaic) kernel would appear —
    and carries the one sketch form (the `sketch` named scope)."""
    text = _lowered_text(variant)
    assert "custom_call" not in text
    assert "sketch" in text


def test_no_module_imports_pallas():
    pat = re.compile(r"jax\.experimental(\.pallas| import pallas)")
    hits = [
        str(p.relative_to(REPO))
        for p in REPO.rglob("*.py")
        if ".smoke_work" not in p.parts and pat.search(p.read_text())
    ]
    assert hits == []


def _cache_dir_in_subprocess(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = (
        "from ntlink_jax import jax_setup; jax_setup.configure(); "
        "import jax; print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_subprocess(want) == want


def test_compile_cache_default_inside_checkout():
    from ntlink_jax import jax_setup

    got = _cache_dir_in_subprocess(None)
    assert got == jax_setup.DEFAULT_CACHE_DIR == str(REPO / ".jax_cache")


class _DeviceBroken(RuntimeError):
    pass


@pytest.mark.parametrize("backend", ["auto", "jax", "hybrid"])
def test_device_error_propagates(backend, monkeypatch):
    """A device error that is not a missing JAX install never degrades to
    the host path, whatever the backend."""
    from ntlink_jax import device_map, pipeline

    def broken(self, *a, **kw):
        raise _DeviceBroken("device failed to start")

    monkeypatch.setattr(device_map.DeviceMapper, "__init__", broken)
    idx, _ = _index(np.random.default_rng(1))
    with pytest.raises(_DeviceBroken):
        pipeline._make_device_mapper(ScaffoldConfig(backend=backend), idx)


@pytest.mark.parametrize("backend,degrades", [("auto", True), ("jax", False)])
def test_missing_jax_degrades_only_for_auto(backend, degrades, monkeypatch):
    import ntlink_jax.ops
    from ntlink_jax import pipeline, sketch

    idx, _ = _index(np.random.default_rng(1))
    # an import that fails as it does when JAX is not installed
    monkeypatch.setitem(sys.modules, "ntlink_jax.device_map", None)
    monkeypatch.setitem(sys.modules, "ntlink_jax.ops.sketch_jax", None)
    monkeypatch.delattr(ntlink_jax.ops, "sketch_jax", raising=False)
    cfg = ScaffoldConfig(backend=backend)
    if degrades:
        assert pipeline._make_device_mapper(cfg, idx) is None
        assert sketch.get_backend(backend) is None
    else:
        with pytest.raises(ImportError):
            pipeline._make_device_mapper(cfg, idx)
        with pytest.raises(ImportError):
            sketch.get_backend(backend)


def test_sketch_stream_error_propagates(monkeypatch):
    from ntlink_jax import sketch
    from ntlink_jax.ops import sketch_jax

    def broken(*a, **kw):
        raise _DeviceBroken("step failed")

    monkeypatch.setattr(sketch_jax, "_sketch_step", lambda: broken)
    backend = sketch.get_backend("auto", threads=1)
    assert isinstance(backend, sketch_jax.JaxSketcher)
    with pytest.raises(_DeviceBroken):
        list(backend.sketch_stream(iter([("s", "ACGT" * 300)]), K, W))


@pytest.mark.parametrize("verbose", [False, True])
def test_run_counters_show_device_work(verbose, tmp_path, monkeypatch):
    """backend=jax on a small synthetic draft: the tracer counts every read
    as device-mapped and every contig as device-sketched."""
    from ntlink_jax import tracing
    from ntlink_jax.pipeline import pair_stage
    from ntlink_jax.synth import write_dataset

    monkeypatch.chdir(tmp_path)
    write_dataset("reads.fa", {"draft.fa": False}, 4, 20_000, 64,
                  read_len=3000)
    monkeypatch.setattr(tracing.GLOBAL, "enabled", True)
    monkeypatch.setattr(tracing.GLOBAL, "counters", {})
    cfg = ScaffoldConfig(target="draft.fa", reads=["reads.fa"], k=K, w=W,
                         z=100, backend="jax", verbose=verbose, t=2)
    pair_stage(cfg)
    c = tracing.GLOBAL.counters
    assert c["map/reads"] == 64
    assert c["map/device_reads"] == 64
    assert c["map/device_host_fallbacks"] == 0
    assert c["sketch/device_rows"] == 4
    assert c["sketch/host_fallbacks"] == 0


@pytest.mark.gpu
def test_gpu_mapping_step_matches_host(gpu_device):
    """On the card: one batch through the device mapper equals the NumPy
    sketch + sorted-index join, read for read."""
    from ntlink_jax.device_map import DeviceMapper

    rng = np.random.default_rng(9)
    idx, seqs = _index(rng, n_contigs=4, length=20_000)
    reads = []
    for i in range(64):
        s = seqs[f"c{i % 4}"]
        start = int(rng.integers(0, len(s) - 3000))
        reads.append((f"r{i}", nthash_np.encode(s[start : start + 3000])))
    dm = DeviceMapper(idx, K, W, with_hashes=False)
    assert dm.n_devices >= 1
    for (name, codes), (gname, _, raw) in zip(
        reads, dm.map_stream_raw(iter(reads))
    ):
        mins = nthash_np.sketch_codes(codes, K, W)
        found = idx.lookup_many(mins.hashes)[0]
        assert gname == name
        assert raw is not None and raw[0] == int(found.sum())
        assert np.array_equal(raw[1], mins.positions[found].astype(np.int32))
    assert dm.host_fallbacks == 0
