"""Quick device-leg probe: mapping throughput vs batch_bases on the live
device (the runs-only payload is tiny, so larger batches may win). Usage: python scripts/probe_batch.py [MB ...]"""
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np  # noqa: E402

import bench  # noqa: E402
from ntlink_jax import pipeline  # noqa: E402
from ntlink_jax.config import ScaffoldConfig  # noqa: E402
from ntlink_jax.device_map import DeviceMapper  # noqa: E402


def main():
    sizes = [int(a) * 1_000_000 for a in sys.argv[1:]] or [
        16_000_000, 32_000_000, 64_000_000
    ]
    contigs, reads, contig_lengths, index = bench.build_workload()
    reads_fa = "/tmp/ntlink_bench_reads.fa"
    with open(reads_fa, "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")
    clen = np.zeros(len(index.contig_names), np.int32)
    for i, nme in enumerate(index.contig_names):
        clen[i] = contig_lengths[nme]
    for bb in sizes:
        dm = DeviceMapper(
            index, bench.K, bench.W, batch_bases=bb,
            with_hashes=False, prechain=(clen, bench.Z), runs_only=True,
        )
        cfg = ScaffoldConfig(
            k=bench.K, w=bench.W, z=bench.Z, reads=[reads_fa],
            batch_bases=bb,
        )
        # warm
        warm_fa = "/tmp/ntlink_bench_warm.fa"
        with open(warm_fa, "w") as fh:
            for name, seq in reads[:64]:
                fh.write(f">{name}\n{seq}\n")
        wcfg = ScaffoldConfig(
            k=bench.K, w=bench.W, z=bench.Z, reads=[warm_fa], batch_bases=bb
        )
        pipeline.map_reads(wcfg, index, contig_lengths, None, None, mapper=dm)
        dm.wire_stats.update(h2d=0, d2h=0, h2d_s=0.0, d2h_s=0.0)
        best = None
        for _ in range(3):
            t0 = time.time()
            t = pipeline.map_reads(
                cfg, index, contig_lengths, None, None, mapper=dm
            )
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        n = len(reads)
        print(
            f"batch_bases={bb//1_000_000}M: best {best:.2f}s -> "
            f"{n/best:.0f} reads/s  pairs={len(t.pairs)}  "
            f"wire={dm.wire_stats}",
            flush=True,
        )


if __name__ == "__main__":
    main()
