"""Bounded human-scale stress: full 3 Gbase contig index on the GPU.

Validates the DESIGN.md replicated-index sizing claim (~60 M minimizers for
a 3 Gbase assembly at w=100) with measured numbers: native TSV index parse
time, host RSS, device HBM residency after the index device_put, flat-cap
adaptation, and mapping reads/s against the full-scale index over a bounded
read slice (so the run completes in minutes; throughput per read is
independent of how many reads follow).

Usage: python scripts/stress_3g_bounded.py <dir-with-target.fa.k32.w100.tsv
       and reads.fa> [n_reads]
"""
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

d = sys.argv[1]
n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 20000
os.chdir(d)

from ntlink_jax.index import ContigIndex  # noqa: E402


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


t0 = time.time()
idx = ContigIndex.from_tsv("target.fa.k32.w100.tsv")
t_parse = time.time() - t0
print(
    f"index parse: {idx.hashes.size} minimizers, {len(idx.contig_names)} "
    f"contigs in {t_parse:.1f}s, host RSS {rss_gb():.2f} GB",
    flush=True,
)

import jax  # noqa: E402

from ntlink_jax.device_map import DeviceMapper  # noqa: E402

t0 = time.time()
mapper = DeviceMapper(idx, k=32, w=100)
dev = jax.devices()[0]
stats = dev.memory_stats() or {}
hbm_gb = stats.get("bytes_in_use", 0) / 1e9
print(
    f"device index resident in {time.time()-t0:.1f}s, "
    f"HBM in use {hbm_gb:.2f} GB "
    f"(limit {stats.get('bytes_limit', 0)/1e9:.1f} GB)",
    flush=True,
)


def read_slice(path, n):
    import itertools

    from ntlink_jax.seqio.fastx import stream_codes

    yield from itertools.islice(stream_codes(path), n)


t0 = time.time()
reads = bases = 0
for name, ln, raw in mapper.map_stream_raw(read_slice("reads.fa", n_reads)):
    reads += 1
    bases += ln
dt = time.time() - t0
stats = dev.memory_stats() or {}
print(
    f"mapped {reads} reads / {bases/1e6:.0f} Mbase vs full 3G index in "
    f"{dt:.1f}s -> {reads/dt:.0f} reads/s, {bases/dt/1e6:.1f} Mbase/s; "
    f"peak HBM {stats.get('peak_bytes_in_use', 0)/1e9:.2f} GB, "
    f"host RSS {rss_gb():.2f} GB",
    flush=True,
)
print("OK", flush=True)
