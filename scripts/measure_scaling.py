"""Throughput scaling measurement (BASELINE.md north star #3).

Two legs, both runnable on one CPU host:

A. Virtual device mesh (1/2/4/8 CPU devices, jax
   xla_force_host_platform_device_count): times the sharded mapping step.
   Virtual devices share the same physical cores, so WALL time cannot
   improve — the meaningful number is cpu-seconds overhead: how much extra
   work sharding the batch over N devices adds (padding, collectives,
   per-shard dispatch). overhead_N = cpu_N / cpu_1; on real chips each
   shard runs on its own silicon, so wall_N ~= wall_1 * overhead_N / N.

B. Multi-process DirTransport (1/2/4 ranks on this 4-core host): a FIXED
   total read workload sharded by file across ranks, each rank mapping on
   the pure-CPU path (backend=numpy, t=1 so ranks don't oversubscribe),
   then the file-ordered tally all-gather. Processes are real parallel
   hardware (separate cores), so efficiency_N = T_1 / (N * T_N) is a true
   scaling-efficiency measurement of the engine's host-parallel design
   (per-file sharding + associative tally merge, distributed.py). Across
   GPU hosts the same exchange rides jax.distributed instead of a shared
   directory; the exchanged payload (the pair tally) is KBs per host and
   independent of read volume, so the transport is never the scaling
   bottleneck — the measured efficiency here is dominated by compute
   partitioning, exactly as it would be across hosts.

Writes scaling.json in the working directory (or the given path).

Usage: python scripts/measure_scaling.py [out.json]
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

K, W, Z = 32, 100, 1000


def make_dataset(n_contigs=8, contig_len=250_000, n_reads=6000,
                 read_len=12_000, seed=42):
    """Junction-bearing workload (bench.make_dataset): reads are drawn from
    a genome whose contigs abut across short unassembled gaps, so the pair
    tally — and hence the all-gather payload this harness measures — is
    non-trivial under load."""
    import bench

    rng = np.random.default_rng(seed)
    return bench.make_dataset(
        rng, n_contigs=n_contigs, contig_len=contig_len, n_reads=n_reads,
        read_len=read_len,
    )


VMESH_DRIVER = r"""
import json, os, sys, time
n_dev = int(sys.argv[1])
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=" + str(n_dev)
).strip()
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, {repo!r} + "/scripts")
from measure_scaling import make_dataset, K, W
from ntlink_jax.index import ContigIndex
from ntlink_jax.device_map import DeviceMapper
from ntlink_jax.ops import nthash_np

contigs, reads = make_dataset(n_reads=768)
index = ContigIndex.from_sketches(
    (n, nthash_np.sketch_sequence(s, K, W)) for n, s in contigs.items()
)
mapper = DeviceMapper(index, K, W, batch_bases=8_000_000)
codes = [(n, nthash_np.encode(s)) for n, s in reads]
# warm (compile)
for _ in mapper.map_stream_raw(iter(codes[:64])):
    pass
t0w, t0c = time.perf_counter(), time.process_time()
n = 0
for _ in mapper.map_stream_raw(iter(codes)):
    n += 1
wall, cpu = time.perf_counter() - t0w, time.process_time() - t0c
print(json.dumps({{"n_devices": n_dev, "reads": n, "wall_s": round(wall, 3),
                  "cpu_s": round(cpu, 3)}}))
"""

RANK_DRIVER = r"""
import json, os, sys, time
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import dataclasses
from ntlink_jax import pipeline
from ntlink_jax.config import ScaffoldConfig
from ntlink_jax.index import ContigIndex
from ntlink_jax.pairs import PairTally
from ntlink_jax.parallel.distributed import (
    all_gather_file_tallies, maybe_init_distributed,
)

workdir, tsv = sys.argv[1], sys.argv[2]
read_files = sys.argv[3:]
os.chdir(workdir)
pid, n = maybe_init_distributed()
index = ContigIndex.from_tsv(tsv)
from ntlink_jax.pipeline import read_scaffold_lengths
contig_lengths = read_scaffold_lengths("target.fa")
cfg = ScaffoldConfig(k={k}, w={w}, z={z}, backend="numpy", t=1,
                     reads=read_files)
t0, c0 = time.perf_counter(), time.process_time()
per_file = {{}}
n_reads = 0
for fi, rf in enumerate(read_files):
    if fi % n != pid:
        continue
    sub = dataclasses.replace(cfg, reads=[rf])
    per_file[fi] = pipeline.map_reads(sub, index, contig_lengths, None, None)
map_s = time.perf_counter() - t0
map_cpu_s = time.process_time() - c0
t1 = time.perf_counter()
tally = all_gather_file_tallies(
    per_file, PairTally(contig_lengths, cfg.k, cfg.f)
)
allgather_s = time.perf_counter() - t1
pair_sig = sorted(
    (str(pk), tuple(ev.gap_estimates), ev.anchor)
    for pk, ev in tally.pairs.items()
)
import hashlib
print(json.dumps({{"rank": pid, "map_s": round(map_s + allgather_s, 3),
                   "map_only_s": round(map_s, 3),
                   "map_cpu_s": round(map_cpu_s, 3),
                   "allgather_s": round(allgather_s, 3),
                   "pairs": len(tally.pairs),
                   "tally_sha": hashlib.sha256(
                       repr(pair_sig).encode()).hexdigest()[:16]}}))
"""


def leg_a():
    results = []
    for n_dev in (1, 2, 4, 8):
        proc = subprocess.run(
            [sys.executable, "-c", VMESH_DRIVER.format(repo=REPO), str(n_dev)],
            capture_output=True, text=True, timeout=900,
        )
        line = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        if not line:
            print(f"vmesh n={n_dev} failed:\n{proc.stderr[-2000:]}",
                  file=sys.stderr)
            continue
        row = json.loads(line[-1])
        results.append(row)
        print(f"# vmesh {row}", file=sys.stderr)
    if results and results[0]["cpu_s"] > 0:
        base = results[0]["cpu_s"]
        for row in results:
            row["cpu_overhead_vs_1dev"] = round(row["cpu_s"] / base, 3)
            row["projected_real_chip_speedup"] = round(
                row["n_devices"] / (row["cpu_s"] / base), 2
            )
    return results


def leg_b(tmp):
    from ntlink_jax.ops import nthash_np
    from ntlink_jax.index import ContigIndex
    from ntlink_jax.sketch import sketch_fasta_to_tsv

    os.makedirs(tmp, exist_ok=True)
    contigs, reads = make_dataset(n_reads=8000)
    target = os.path.join(tmp, "target.fa")
    with open(target, "w") as fh:
        for n, s in contigs.items():
            fh.write(f">{n}\n{s}\n")
    # 8 read files so every rank count divides evenly
    files = []
    for i in range(8):
        p = os.path.join(tmp, f"reads{i}.fa")
        with open(p, "w") as fh:
            for j, (n, s) in enumerate(reads):
                if j % 8 == i:
                    fh.write(f">{n}\n{s}\n")
        files.append(os.path.basename(p))
    tsv = os.path.join(tmp, "target.k32.w100.tsv")
    sketch_fasta_to_tsv(target, tsv, K, W)

    results = []
    # 8 ranks on a 4-core host is deliberately oversubscribed (VERDICT r4
    # #8): wall cannot scale past the cores, so the 8-rank row's meaning
    # is (a) the merge/all-gather path stays flat and byte-identical and
    # (b) total map CPU does not blow up super-linearly
    for n_proc in (1, 2, 4, 8):
        group = os.path.join(tmp, f"group{n_proc}")
        procs = []
        t0 = time.perf_counter()
        for pid in range(n_proc):
            env = dict(os.environ)
            env.update(
                NTLINK_GROUP_DIR=group,
                NTLINK_NUM_PROCESSES=str(n_proc),
                NTLINK_PROCESS_ID=str(pid),
            )
            if n_proc == 1:
                env.pop("NTLINK_NUM_PROCESSES")
                env.pop("NTLINK_PROCESS_ID")
            procs.append(
                subprocess.Popen(
                    [
                        sys.executable, "-c",
                        RANK_DRIVER.format(repo=REPO, k=K, w=W, z=Z),
                        tmp, tsv, *files,
                    ],
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True,
                )
            )
        rows = []
        for p in procs:
            out, err = p.communicate(timeout=1200)
            if p.returncode != 0:
                print(f"rank failed:\n{err[-2000:]}", file=sys.stderr)
                continue
            rows.append(json.loads(
                [l for l in out.splitlines() if l.startswith("{")][-1]
            ))
        wall = time.perf_counter() - t0
        if len(rows) != n_proc:
            continue
        slowest = max(r["map_s"] for r in rows)
        shas = {r["tally_sha"] for r in rows}
        assert len(shas) == 1, f"rank tallies diverged: {shas}"
        results.append({
            "n_processes": n_proc,
            "map_s_slowest_rank": slowest,
            "map_cpu_s_total": round(sum(r["map_cpu_s"] for r in rows), 3),
            "allgather_s_max": round(
                max(r["allgather_s"] for r in rows), 3
            ),
            "wall_s_incl_startup": round(wall, 3),
            "reads_per_s": round(len(reads) / slowest, 1),
            "pairs": rows[0]["pairs"],
            "tally_sha": rows[0]["tally_sha"],
        })
        print(f"# dirtransport {results[-1]}", file=sys.stderr)
    if results:
        t1 = results[0]["map_s_slowest_rank"]
        cpu1 = results[0]["map_cpu_s_total"]
        sha1 = results[0]["tally_sha"]
        for row in results:
            row["speedup"] = round(t1 / row["map_s_slowest_rank"], 2)
            row["efficiency"] = round(
                t1 / (row["n_processes"] * row["map_s_slowest_rank"]), 3
            )
            # oversubscribed ranks: wall efficiency is core-bound by
            # construction; CPU efficiency shows partitioning overhead
            row["cpu_efficiency"] = round(cpu1 / row["map_cpu_s_total"], 3)
            assert row["tally_sha"] == sha1, "tally diverged across rank counts"
    return results


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.getcwd(), "scaling.json"
    )
    import tempfile

    payload = {
        "host_cores": os.cpu_count(),
        "virtual_device_mesh": leg_a(),
        "multi_process_dirtransport": leg_b(tempfile.mkdtemp(prefix="ntscale")),
        "note": (
            "virtual CPU devices share cores: the mesh leg measures sharding "
            "cpu-overhead (real chips get n_devices/overhead speedup); the "
            "multi-process leg is true wall-clock scaling on separate cores "
            "with the production per-file sharding + tally all-gather"
        ),
    }
    with open(out_path, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
