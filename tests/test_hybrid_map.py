"""Hybrid (device+host) mapping: ordering, payload parity, e2e bytes."""
import filecmp
import os
import shutil

import numpy as np
import pytest


from ntlink_jax.device_map import DeviceMapper
from ntlink_jax.host_map import HostMapper
from ntlink_jax.hybrid_map import HybridMapper
from ntlink_jax.index import ContigIndex
from ntlink_jax.native import chain_module, sketch_module
from ntlink_jax.ops import nthash_np as nt

pytestmark = pytest.mark.skipif(
    chain_module() is None or sketch_module() is None,
    reason="C build unavailable",
)

K, W = 32, 100


def _workload(n_reads=300, seed=9):
    rng = np.random.default_rng(seed)
    contig = "".join("ACGT"[c] for c in rng.integers(0, 4, 120_000))
    index = ContigIndex.from_sketches(
        [("c1", nt.sketch_sequence(contig, K, W))]
    )
    reads = []
    for i in range(n_reads):
        s = int(rng.integers(0, 100_000))
        ln = int(rng.integers(K, 15_000))
        codes = nt.encode(contig[s : s + ln])
        if i % 7 == 0:
            codes = codes.copy()
            codes[rng.integers(0, len(codes), 5)] = 4
        reads.append((f"r{i}", codes))
    return index, reads


@pytest.mark.parametrize("host_frac", [-1.0, 0.0, 0.5, 1.0])
def test_hybrid_matches_device_payloads(host_frac):
    index, reads = _workload()
    dm = DeviceMapper(index, K, W)
    hm = HostMapper(index, K, W, threads=2)
    hy = HybridMapper(DeviceMapper(index, K, W), hm, host_frac=host_frac)

    want = list(dm.map_stream_raw(iter(reads)))
    got = list(hy.map_stream_raw(iter(reads)))
    assert [g[0] for g in got] == [r[0] for r in reads]  # strict order
    assert len(got) == len(want)
    for (gn, gl, graw), (wn, wl, wraw) in zip(got, want):
        assert (gn, gl) == (wn, wl)
        assert (graw is None) == (wraw is None)
        if wraw is None:
            continue
        assert graw[0] == wraw[0]
        for a, b in zip(graw[1:], wraw[1:]):
            assert np.array_equal(np.asarray(a)[: wraw[0]],
                                  np.asarray(b)[: wraw[0]]), gn
    if host_frac == 1.0:
        assert hy.host_reads == len(reads)
    if host_frac == 0.0:
        assert hy.device_reads == len(reads)


def test_hybrid_adaptive_uses_both_paths():
    index, reads = _workload(n_reads=1200)
    dm = DeviceMapper(index, K, W)
    # pre-warm the device jit AT THE FULL BLOCK HEIGHT: a cold compile can
    # exceed STALL_RESCUE_S, letting the host path legitimately rescue-and-
    # win the device's only block on this short stream (correct behavior,
    # but not what this test is about)
    for _ in dm.map_stream_raw(iter(reads[:1024])):
        pass
    hy = HybridMapper(
        dm,
        HostMapper(index, K, W, threads=2),
        host_frac=-1.0,
    )
    for _ in hy.map_stream_raw(iter(reads)):
        pass
    assert hy.host_reads + hy.device_reads == len(reads)
    # adaptive policy should not degenerate to a single path on a stream
    # this long (both priors are finite)
    assert hy.host_reads > 0
    assert hy.device_reads > 0


def test_hybrid_propagates_worker_errors():
    index, reads = _workload(n_reads=100)

    class Boom:
        contig_names = index.contig_names
        _contig_order = {n: i for i, n in enumerate(index.contig_names)}

        def map_stream_raw(self, it):
            for i, (name, codes) in enumerate(it):
                if i == 10:
                    raise RuntimeError("boom")
                yield name, len(codes), None

    hy = HybridMapper(
        Boom(), HostMapper(index, K, W, threads=2), host_frac=0.0
    )
    with pytest.raises(RuntimeError, match="boom"):
        for _ in hy.map_stream_raw(iter(reads)):
            pass


def test_idle_path_flushes_partial_batches():
    """A path that stops receiving work must flush its internal partial
    batches within ~IDLE_FLUSH_S (stream restart), not hold its sequence
    numbers until end-of-input."""
    import time

    from ntlink_jax.hybrid_map import _ReorderSink, _Runner

    class Batchy:
        """Only emits results when its input stream ENDS (worst-case
        internal batching, like a partially-filled device bucket)."""

        def map_stream_raw(self, it):
            held = [(n, len(c), None) for n, c in it]
            yield from held

    sink = _ReorderSink()
    r = _Runner("batchy", Batchy(), sink, prior_rate=1e6)
    r.start()
    try:
        block = [(i, f"r{i}", np.zeros(100, np.uint8)) for i in range(4)]
        r.submit(block)
        deadline = time.time() + 5.0
        while time.time() < deadline:
            with sink.lock:
                if len(sink.buf) == 4:
                    break
            time.sleep(0.05)
        with sink.lock:
            assert len(sink.buf) == 4, "idle flush never happened"
        # a second wave after the restart must also work
        r.submit([(i, f"s{i}", np.zeros(100, np.uint8))
                  for i in range(4, 8)])
        deadline = time.time() + 5.0
        while time.time() < deadline:
            with sink.lock:
                if len(sink.buf) == 8:
                    break
            time.sleep(0.05)
        with sink.lock:
            assert len(sink.buf) == 8
    finally:
        r.close()
        r.join()


def test_crashed_mapping_leaves_no_partial_checkpoint(tmp_path):
    """A mapping failure must leave neither verbose_mapping.tsv nor its
    .tmp behind — a truncated file would be silently trusted as a complete
    checkpoint on rerun (crash-safety: tmp + rename-on-success)."""
    from ntlink_jax import pipeline
    from ntlink_jax.config import ScaffoldConfig

    index, reads = _workload(n_reads=50)

    class Boom:
        contig_names = index.contig_names
        _contig_order = {n: i for i, n in enumerate(index.contig_names)}

        def map_stream_raw(self, it):
            for i, (name, codes) in enumerate(it):
                if i == 10:
                    raise RuntimeError("boom")
                yield name, len(codes), None

    reads_fa = tmp_path / "reads.fa"
    with open(reads_fa, "w") as fh:
        for name, codes in reads:
            fh.write(f">{name}\n{'ACGT' * 16}\n")
    cfg = ScaffoldConfig(k=K, w=W, z=1000, reads=[str(reads_fa)])
    verbose = str(tmp_path / "verbose_mapping.tsv")
    lengths = {"c1": 120_000}
    with pytest.raises(RuntimeError, match="boom"):
        pipeline.map_reads(cfg, index, lengths, verbose, None, mapper=Boom())
    assert not os.path.exists(verbose)
    assert not os.path.exists(verbose + ".tmp")


def test_hybrid_e2e_scaffold_bytes(ref_tests_dir, tmp_path):
    """backend=hybrid produces byte-identical artifacts to backend=auto."""
    from ntlink_jax.config import ScaffoldConfig
    from ntlink_jax.pipeline import run_scaffold

    outs = {}
    for backend in ("auto", "hybrid"):
        d = tmp_path / backend
        os.makedirs(d)
        for f in ("scaffolds_2.fa", "long_reads_2.fq.gz"):
            shutil.copy(os.path.join(ref_tests_dir, f), d)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            cfg = ScaffoldConfig(
                target="scaffolds_2.fa", reads=["long_reads_2.fq.gz"],
                k=32, w=100, z=1000, verbose=True, backend=backend,
                hybrid_host_frac=0.5,
            )
            run_scaffold(cfg, gap_fill=False)
        finally:
            os.chdir(cwd)
        outs[backend] = d
    prefix = "scaffolds_2.fa.k32.w100.z1000"
    for artifact in (
        f"{prefix}.verbose_mapping.tsv",
        f"{prefix}.n1.scaffold.dot",
        f"{prefix}.stitch.abyss-scaffold.fa",
    ):
        a = outs["auto"] / artifact
        b = outs["hybrid"] / artifact
        assert filecmp.cmp(a, b, shallow=False), artifact


def test_stalled_path_rescued_by_idle_path():
    """A path that wedges (e.g. first device batch stuck behind a long
    compile) must not strand the stream: after STALL_RESCUE_S the idle
    path re-runs the stranded items and the stream completes."""
    import threading

    from ntlink_jax.hybrid_map import HybridStream

    class WedgedPath:
        """Consumes input, never produces output."""

        def map_stream_raw(self, named_codes):
            for _ in named_codes:
                threading.Event().wait(3600)  # block forever
            return
            yield  # pragma: no cover

    class EchoPath:
        def map_stream_raw(self, named_codes):
            for name, codes in named_codes:
                yield name, len(codes), ("echo", name)

    sched = HybridStream(WedgedPath(), EchoPath(), host_frac=0.0)
    sched.BLOCK_READS = 2
    sched.STALL_RESCUE_S = 0.3
    sched.JOIN_TIMEOUT_S = 1.0
    items = [(f"x{i}", np.zeros(10, np.uint8)) for i in range(8)]
    out = list(sched.stream(iter(items)))
    assert [n for n, _, _ in out] == [n for n, _ in items]
    assert all(raw == ("echo", name) for name, _, raw in out)


def test_rescue_survives_stale_fifo_window():
    """Regression (round-4 advisor, hybrid_map.py stall rescue): a wedged
    runner never pops its fifo, so after enough rescued blocks the first
    `window` fifo entries are all already-delivered; the snapshot must
    filter BEFORE windowing or rescue turns into a permanent no-op and
    the final drain spins forever on any backlog > window."""
    import threading

    from ntlink_jax.hybrid_map import HybridStream

    class WedgedPath:
        def map_stream_raw(self, named_codes):
            for _ in named_codes:
                threading.Event().wait(3600)
            return
            yield  # pragma: no cover

    class EchoPath:
        def map_stream_raw(self, named_codes):
            for name, codes in named_codes:
                yield name, len(codes), ("echo", name)

    # host_frac=0.0 routes EVERY block to the wedged path; the snapshot
    # window (4 items) is far smaller than the backlog (32), so several
    # rescues in, the unfiltered window would be 100% stale entries
    sched = HybridStream(WedgedPath(), EchoPath(), host_frac=0.0)
    sched.BLOCK_READS = 2
    sched.RESCUE_BLOCKS = 1
    sched.RESCUE_WINDOW_MIN = 4
    sched.STALL_RESCUE_S = 0.2
    sched.STALL_RETRIGGER_S = 0.05
    sched.JOIN_TIMEOUT_S = 1.0
    items = [(f"x{i}", np.zeros(10, np.uint8)) for i in range(32)]
    done = {}

    def run():
        done["out"] = list(sched.stream(iter(items)))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=30.0)
    assert not t.is_alive(), "hybrid stream hung on a stale rescue window"
    out = done["out"]
    assert [n for n, _, _ in out] == [n for n, _ in items]
    assert all(raw == ("echo", name) for name, _, raw in out)
