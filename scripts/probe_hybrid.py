"""Hybrid-leg probe on the live chip: adaptive vs pinned splits vs host
thread counts. Usage: python scripts/probe_hybrid.py [label=frac:threads ...]
frac < 0 = adaptive."""
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np  # noqa: E402

import bench  # noqa: E402
from ntlink_jax import pipeline  # noqa: E402
from ntlink_jax.config import ScaffoldConfig  # noqa: E402
from ntlink_jax.device_map import DeviceMapper  # noqa: E402
from ntlink_jax.host_map import HostMapper  # noqa: E402
from ntlink_jax.hybrid_map import HybridMapper  # noqa: E402


def main():
    specs = []
    for a in sys.argv[1:]:
        label, rest = a.split("=")
        frac, thr = rest.split(":")
        specs.append((label, float(frac), int(thr)))
    if not specs:
        specs = [("adaptive", -1.0, 4), ("pin0.5", 0.5, 4), ("adaptive3", -1.0, 3)]
    contigs, reads, contig_lengths, index = bench.build_workload()
    reads_fa = "/tmp/ntlink_bench_reads.fa"
    with open(reads_fa, "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")
    clen = np.zeros(len(index.contig_names), np.int32)
    for i, nme in enumerate(index.contig_names):
        clen[i] = contig_lengths[nme]
    bb = 16_000_000
    dm = DeviceMapper(
        index, bench.K, bench.W, batch_bases=bb, with_hashes=False,
        prechain=(clen, bench.Z), runs_only=True,
    )
    warm_fa = "/tmp/ntlink_bench_warm.fa"
    with open(warm_fa, "w") as fh:
        for name, seq in reads[:64]:
            fh.write(f">{name}\n{seq}\n")
    wcfg = ScaffoldConfig(k=bench.K, w=bench.W, z=bench.Z, reads=[warm_fa],
                          batch_bases=bb)
    pipeline.map_reads(wcfg, index, contig_lengths, None, None, mapper=dm)
    cfg = ScaffoldConfig(k=bench.K, w=bench.W, z=bench.Z, reads=[reads_fa],
                         batch_bases=bb, backend="hybrid", t=4)
    n = len(reads)
    for label, frac, thr in specs:
        hm = HybridMapper(
            dm,
            HostMapper(index, bench.K, bench.W, threads=thr,
                       prechain=(clen, bench.Z), runs_only=True),
            frac,
        )
        best = None
        for _ in range(2):
            t0 = time.time()
            t = pipeline.map_reads(
                cfg, index, contig_lengths, None, None, mapper=hm
            )
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        share = hm.device_reads / max(1, hm.device_reads + hm.host_reads)
        print(
            f"{label}: best {best:.2f}s -> {n/best:.0f} reads/s "
            f"(device share {share:.2f}) pairs={len(t.pairs)}",
            flush=True,
        )


if __name__ == "__main__":
    main()
