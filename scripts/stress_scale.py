"""Scale stress: full scaffold+gap_fill pipeline on a synthetic assembly
with joins, run with per-stage tracing and memory capture. Usage:
    python scripts/stress_scale.py [workdir] [n_contigs] [contig_len] [n_reads]

Presets (dataset: ntlink_jax.synth):
    100 Mb:   scripts/stress_scale.py /tmp/ntlink_stress 250 400000 10000
    200 Mb:   scripts/stress_scale.py /tmp/ntlink_stress 500 400000 20000
    human 3G: scripts/stress_scale.py /data 750 4000000 2500000
              (3 Gbase target, 30 Gbase reads = 10x coverage; validates
              DESIGN.md "Scaling sizing" at the scale it is sized for)
"""
import os
import resource
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:

    workdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/ntlink_stress"
    N_CONTIGS = int(sys.argv[2]) if len(sys.argv) > 2 else 250
    CONTIG_LEN = int(sys.argv[3]) if len(sys.argv) > 3 else 400_000
    N_READS = int(sys.argv[4]) if len(sys.argv) > 4 else 10_000
    READ_LEN = 12_000
    GAP = 500

    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)

    GAPPED = bool(os.environ.get("NTLINK_STRESS_GAPPED"))

    # dataset identity includes the gapped flag and the size: a cached
    # target.fa from another config would silently misrepresent what ran
    _marker = (
        f"target.fa.{'gapped' if GAPPED else 'gapless'}"
        f".{N_CONTIGS}x{CONTIG_LEN}.r{N_READS}"
    )
    if os.path.exists("target.fa") and not os.path.exists(_marker):
        for f in os.listdir("."):
            if os.path.isdir(f):
                shutil.rmtree(f)
            else:
                os.remove(f)

    t0 = time.time()
    if not os.path.exists("target.fa"):
        from ntlink_jax.synth import write_dataset

        write_dataset(
            "reads.fa", {"target.fa": GAPPED}, N_CONTIGS, CONTIG_LEN,
            N_READS, read_len=READ_LEN, gap=GAP,
        )
        open(_marker, "w").close()
        print(
            f"dataset generated in {time.time()-t0:.1f}s "
            f"({N_CONTIGS*CONTIG_LEN/1e6:.0f} Mb target, "
            f"{N_READS*READ_LEN/1e6:.0f} Mb reads)",
            flush=True,
        )

    if os.environ.get("NTLINK_STRESS_GEN_ONLY"):
        # dataset staging only (generation is CPU-only and can overlap
        # other device work)
        sys.exit(0)

    from ntlink_jax import tracing
    from ntlink_jax.config import ScaffoldConfig
    from ntlink_jax.pipeline import run_scaffold


    def device_mem(tag):
        try:
            import jax

            stats = jax.devices()[0].memory_stats() or {}
            used = stats.get("bytes_in_use") or stats.get("peak_bytes_in_use")
            if used is not None:
                print(f"HBM[{tag}]: {used/2**30:.2f} GiB in use "
                      f"(peak {stats.get('peak_bytes_in_use', 0)/2**30:.2f})",
                      flush=True)
        except Exception:
            pass


    tracing.enable()
    cfg = ScaffoldConfig(
        target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000,
        backend=os.environ.get("NTLINK_STRESS_BACKEND", "auto"),
    )
    t0 = time.time()
    final = run_scaffold(cfg, gap_fill=True)
    print(f"TOTAL scaffold+gap_fill: {time.time()-t0:.1f}s", flush=True)
    device_mem("end")
    print(
        f"peak RSS: {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss/2**20:.2f} GiB",
        flush=True,
    )

    # verify: how many of the expected joins happened?
    from ntlink_jax.pathio import read_path_file

    paths = list(read_path_file(cfg.resolved_prefix() + ".trimmed_scafs.path"))
    joined = sum(len([t for t in toks if not t.endswith("N")]) - 1 for _, toks in paths)
    print(f"paths: {len(paths)}; joins made: {joined}/{N_CONTIGS-1}", flush=True)


if __name__ == "__main__":
    main()
