#!/usr/bin/env python3
"""Sketch cost on the GPU: is a hand-written sketch kernel worth writing?

    python3 scripts/measure_sketch.py [outdir]

1. XLA's sketch (ops.sketch_jax.sketch_batch_kernel) alone at B x L =
   1024 x 16384 and 8 x 2^21, after warm-up, timed with block_until_ready:
   Gbase/s.
2. Compile time and memory_analysis of the runs-only mapping step at the
   largest pads: L=2^17 (the two-stage top_k selection at 4096 slots) and
   L=2^21 (the flat argsort selection, 65536 slots).
3. One profiler trace of the fused mapping step (runs-only, 512 x 16384,
   real reads against a 100 Mb draft's index): the share of the step's
   device time spent in the fusions under the `sketch` named scope
   (parallel.mesh.sketch_rows). A host-clock cross-check times the sketch
   alone against the whole step at the same shape.

Prints its results and writes the trace summary to
<outdir>/sketch_trace_summary.txt (default chiprun_out/). Needs a GPU.
"""
import glob
import os
import shutil
import statistics
import subprocess
import sys
import time

os.environ["JAX_PLATFORMS"] = "cuda"
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

K, W, Z = 32, 100, 1000


def timed(fn, *args, reps: int = 7):
    jax.block_until_ready(fn(*args))  # compile + warm
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), statistics.median(ts)


def sketch_rates(rng) -> None:
    from ntlink_jax.ops.sketch_jax import sketch_batch_kernel

    f = jax.jit(lambda c, l: sketch_batch_kernel(c, l, K, W))
    for B, L in ((1024, 1 << 14), (8, 1 << 21)):
        codes = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
        lengths = jnp.full((B,), L, jnp.int32)
        best, med = timed(f, codes, lengths)
        print(f"sketch alone B={B} L={L}: best {best * 1e3:.3f} ms "
              f"({B * L / best / 1e9:.2f} Gbase/s), median "
              f"{med * 1e3:.3f} ms ({B * L / med / 1e9:.2f} Gbase/s)",
              flush=True)


def make_index(workdir: str, n_reads: int):
    from ntlink_jax.index import ContigIndex
    from ntlink_jax.seqio import stream_fastx
    from ntlink_jax.sketch import sketch_sequences
    from ntlink_jax.synth import write_dataset

    os.makedirs(workdir, exist_ok=True)
    draft = os.path.join(workdir, "draft.fa")
    reads = os.path.join(workdir, "reads.fa")
    write_dataset(reads, {draft: False}, 250, 400_000, n_reads)
    named = ((r.name, r.seq) for r in stream_fastx(draft))
    index = ContigIndex.from_sketches(
        (n, m) for n, _, m in sketch_sequences(named, K, W, threads=8)
    )
    lengths = {r.name: len(r.seq) for r in stream_fastx(draft)}
    clen = np.array([lengths[n] for n in index.contig_names], np.int32)
    return index, clen, reads


def step_args(dm, L: int):
    d = dm.didx
    pack = d.t_off is not None
    t_off = d.t_off if pack else jnp.zeros(1, jnp.uint32)
    return (d.t_bkt, t_off, dm._clen_dev, K, W, L, d.mask, d.max_probes,
            dm._slots_for(L), False, pack, True, Z, True)


def compile_large(dm) -> None:
    from ntlink_jax.device_map import _single_device_step
    from ntlink_jax.stream_pipeline import next_pow2

    S = jax.ShapeDtypeStruct
    for L in (1 << 17, 1 << 21):
        B = next_pow2(max(1, dm.batch_bases // L))
        args = (S((B, L // 4), jnp.uint8), S((B,), jnp.int32)) + step_args(
            dm, L
        )
        t0 = time.perf_counter()
        c = _single_device_step().lower(*args).compile()
        dt = time.perf_counter() - t0
        m = c.memory_analysis()
        print(f"compile map runs-only B={B} L={L} slots={dm._slots_for(L)}: "
              f"{dt:.2f} s; temp={m.temp_size_in_bytes / 2**20:.1f}MiB "
              f"argument={m.argument_size_in_bytes / 2**20:.1f}MiB "
              f"output={m.output_size_in_bytes / 2**20:.1f}MiB", flush=True)


def real_batch(reads: str, B: int, L: int):
    from ntlink_jax.ops import nthash_np
    from ntlink_jax.parallel.mesh import pack_codes
    from ntlink_jax.seqio import stream_fastx

    codes = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, rec in enumerate(stream_fastx(reads)):
        if i == B:
            break
        c = nthash_np.encode(rec.seq)
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    return jnp.asarray(pack_codes(codes)), jnp.asarray(lengths)


def stat_text(ev) -> str:
    try:
        return " ".join(f"{k}={v}" for k, v in ev.stats)
    except Exception as exc:  # the stats view varies across JAX versions
        return f"<stats unreadable: {exc!r}>"


def trace_share(dm, reads: str, outdir: str) -> None:
    from ntlink_jax.device_map import _single_device_step
    from ntlink_jax.parallel.mesh import sketch_rows, unpack_codes

    B, L = 512, 1 << 14
    packed, lengths = real_batch(reads, B, L)
    step = _single_device_step()
    args = (packed, lengths) + step_args(dm, L)
    _, med_step = timed(step, *args)
    sk = jax.jit(lambda p, l: sketch_rows(unpack_codes(p, L), l, K, W))
    _, med_sk = timed(sk, packed, lengths)
    print(f"host clock, B={B} L={L}: fused step median "
          f"{med_step * 1e3:.3f} ms, sketch alone median "
          f"{med_sk * 1e3:.3f} ms -> share {med_sk / med_step:.3f}",
          flush=True)

    tdir = os.path.join(outdir, "trace")
    jax.profiler.start_trace(tdir)
    for _ in range(5):
        jax.block_until_ready(step(*args))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(f"{tdir}/**/*.xplane.pb", recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    lines_out, per_name, total, in_sketch = [], {}, 0, 0
    gpu_lines = [
        line for plane in pd.planes if "gpu" in plane.name.lower()
        for line in plane.lines
    ]
    for line in gpu_lines:
        evs = list(line.events)
        lines_out.append(f"{line.name}: {len(evs)} events, "
                         f"{sum(e.duration_ns for e in evs) / 1e6:.3f} ms")
    # kernels sit on the stream lines; derived lines repeat them
    streams = [ln for ln in gpu_lines if "stream" in ln.name.lower()]
    for line in streams or gpu_lines:
        for e in line.events:
            text = stat_text(e)
            total += e.duration_ns
            hit = "sketch" in text
            in_sketch += e.duration_ns if hit else 0
            agg = per_name.setdefault(e.name, [0, 0, hit, text[:400]])
            agg[0] += e.duration_ns
            agg[1] += 1
    share = in_sketch / total if total else float("nan")
    print(f"trace: device time on GPU streams {total / 1e6:.3f} ms over 5 "
          f"steps; in `sketch` scope {in_sketch / 1e6:.3f} ms -> share "
          f"{share:.3f}", flush=True)
    with open(os.path.join(outdir, "sketch_trace_summary.txt"), "w") as fh:
        fh.write("\n".join(lines_out) + "\n\n")
        for name, (dur, n, hit, text) in sorted(
            per_name.items(), key=lambda kv: -kv[1][0]
        )[:60]:
            fh.write(f"{dur / 1e6:10.3f} ms {n:4d}x sketch={hit} {name}\n"
                     f"    {text}\n")


def main() -> None:
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "chiprun_out"
    )
    os.makedirs(outdir, exist_ok=True)
    d0 = jax.devices()[0]
    assert d0.platform == "gpu", d0.platform
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device {d0.device_kind}; {smi}", flush=True)
    rng = np.random.default_rng(0)
    sketch_rates(rng)

    from ntlink_jax.device_map import DeviceMapper

    work = os.path.join(ROOT, ".smoke_work", "measure")
    index, clen, reads = make_index(work, 512)
    dm = DeviceMapper(index, K, W, with_hashes=False, prechain=(clen, Z),
                      runs_only=True)
    trace_share(dm, reads, outdir)
    compile_large(dm)
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
