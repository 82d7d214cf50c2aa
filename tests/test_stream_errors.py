"""Error propagation through the threaded device-stream pipelines.

A failure on the feeder thread (dispatch/compile) or the drainer thread
(transfer/decode) must surface as an exception to the consumer at the next
flush point — never a hang, never silently-missing reads.
"""
import numpy as np
import pytest

from ntlink_jax.device_map import DeviceMapper
from ntlink_jax.index import ContigIndex
from ntlink_jax.ops import nthash_np
from ntlink_jax.ops.sketch_jax import JaxSketcher

K, W = 32, 100


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(3)
    contig = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 50_000)])
    index = ContigIndex.from_sketches(
        [("c0", nthash_np.sketch_sequence(contig, K, W))]
    )
    return index, contig


def _reads(contig, n=40, ln=900):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        s = int(rng.integers(0, len(contig) - ln))
        out.append((f"r{i}", contig[s : s + ln]))
    return out


class Boom(RuntimeError):
    pass


def test_feeder_error_propagates(small_index, monkeypatch):
    index, contig = small_index
    mapper = DeviceMapper(index, K, W, batch_bases=8_192, use_mesh=False)

    def bad_step(pad):
        def step(*a, **kw):
            raise Boom("dispatch failed")
        return step

    monkeypatch.setattr(mapper, "_step_for", bad_step)
    with pytest.raises(Boom):
        list(mapper.map_stream_raw(iter(_reads(contig))))


def test_drainer_error_propagates(small_index, monkeypatch):
    index, contig = small_index
    mapper = DeviceMapper(index, K, W, batch_bases=8_192, use_mesh=False)

    real_step_for = mapper._step_for

    def poison_step(pad):
        real = real_step_for(pad)

        def step(packed, lengths, didx):
            out = dict(real(packed, lengths, didx))
            out["flat"] = _Poison(out["flat"])
            return out

        return step

    class _Poison:
        """Array wrapper whose host materialization fails (as a failed
        device transfer would at the drainer's np.asarray wait).
        Slicing propagates the poison (the dispatch-side cap slice runs
        before any transfer)."""

        def __init__(self, inner):
            self._inner = inner
            self.shape = inner.shape
            self.nbytes = inner.nbytes  # wire-byte accounting reads this

        def __getitem__(self, key):
            return _Poison(self._inner[key])

        def copy_to_host_async(self):
            pass

        def __array__(self, *a, **kw):
            raise Boom("transfer failed")

    monkeypatch.setattr(mapper, "_step_for", poison_step)
    with pytest.raises(Boom):
        list(mapper.map_stream_raw(iter(_reads(contig))))


def test_abandoned_generator_closes_promptly(small_index):
    """Breaking out of the stream mid-flight must shut the pipeline down
    (bounded close) — no hang, and a fresh stream still works."""
    import time

    index, contig = small_index
    mapper = DeviceMapper(index, K, W, batch_bases=8_192, use_mesh=False)
    stream = mapper.map_stream_raw(iter(_reads(contig, n=60)))
    for _ in stream:
        break  # abandon with batches in flight
    t0 = time.time()
    stream.close()
    assert time.time() - t0 < 60
    # the mapper is reusable after an abandoned stream
    n = sum(1 for _ in mapper.map_stream_raw(iter(_reads(contig, n=10))))
    assert n == 10


def test_sketcher_feeder_error_propagates(monkeypatch):
    import ntlink_jax.ops.sketch_jax as sj

    def bad_step():
        def step(*a, **kw):
            raise Boom("sketch dispatch failed")
        return step

    monkeypatch.setattr(sj, "_sketch_step", bad_step)
    rng = np.random.default_rng(5)
    contig = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30_000)])
    sk = JaxSketcher(batch_bases=4_096)
    seqs = [(f"s{i}", contig[i * 1000 : i * 1000 + 2000]) for i in range(20)]
    with pytest.raises(Boom):
        list(sk.sketch_stream(iter(seqs), K, W))
