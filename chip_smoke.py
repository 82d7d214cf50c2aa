#!/usr/bin/env python3
"""GPU smoke test: the mapping path through the normal entry points, on the
GPU, byte for byte against the host path.

    python3 chip_smoke.py              # one GPU: phases 1-5 below
    python3 chip_smoke.py --cards 4    # four GPUs: `pair` on the data mesh
                                       # and on the hash-sharded index only
    python3 chip_smoke.py --rehearse [--cards 4]
                                       # tiny sizes on the CPU; prints no
                                       # result line

Phases; each passes or ends the script with a non-zero exit:
1. Environment: platform, device kind and count, the card's name and power
   limit, the JAX version, the native C modules that built.
2. Data: a 100 Mb draft (250 x 400 kb contigs, 500 bp true gaps), a copy of
   it with N runs in every contig, and 30,000 reads of 12 kb at 4%
   substitutions, half reverse-complemented, all from one seed
   (ntlink_jax.synth).
3. Steps: each step variant the run uses is compiled at the run's shapes
   (compile time and memory_analysis printed), and one real batch of reads
   is compared with the NumPy sketch (ops/nthash_np.py) plus the C chain.
4. End to end: `pair` (non-verbose), `scaffold gap_fill` and `run_rounds
   rounds=2` (on the N-rich draft) each run through ntlink_jax.cli.main
   with backend=jax and with backend=numpy; every artifact must be
   byte-identical, and more than 99% of the reads must map on the device.
5. The last line: {"ok": true, "device": {"platform", "kind", "count"}}.

JAX is pinned to CUDA, so a broken CUDA plugin is an error, never a CPU
run. Everything runs in this one process: a JAX process reserves most of
each card's memory, so no second process may open the card.
"""
import argparse
import contextlib
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")

K, W, Z = 32, 100, 1000
THREADS = 8
SIZES = {
    "full": dict(n_contigs=250, contig_len=400_000, n_reads=30_000),
    "rehearse": dict(n_contigs=12, contig_len=60_000, n_reads=600),
}
BATCH_READS = 512  # reads in the phase-3 batch: one full 16 kb bucket


def say(*parts) -> None:
    print(*parts, flush=True)


def phase(name: str):
    say(f"\n=== {name}")
    return time.perf_counter()


def done(t0: float) -> None:
    say(f"--- {time.perf_counter() - t0:.1f} s")


# -- phase 1 ---------------------------------------------------------------

def environment(args):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    say(f"platform={d0.platform} device_kind={d0.device_kind} "
        f"count={len(devs)}")
    want = "cpu" if args.rehearse else "gpu"
    if d0.platform != want or len(devs) != args.cards:
        raise RuntimeError(
            f"want {args.cards} {want} device(s), JAX sees {len(devs)} "
            f"{d0.platform}"
        )
    if args.rehearse:
        say("nvidia-smi: not run (rehearsal)")
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
        for line in smi.stdout.strip().splitlines():
            say(line.strip())
    say(f"jax {jax.__version__}")
    from ntlink_jax.native import build

    failed = {}
    for name in sorted(build.MODULES):
        try:
            build.load(name)
            say(f"native {name}: built")
        except Exception as exc:  # reported; required ones fail below
            failed[name] = exc
            say(f"native {name}: FAILED ({exc!r})")
    missing = {"ntlink_chain", "ntlink_sketch"} & set(failed)
    if missing:
        raise RuntimeError(
            f"the device path needs the C modules {sorted(missing)}"
        )
    return devs


# -- phase 2 ---------------------------------------------------------------

def make_data(size):
    from ntlink_jax.synth import write_dataset

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    paths = {
        "draft": os.path.join(WORK, "draft.fa"),
        "draft_n": os.path.join(WORK, "draft_n.fa"),
        "reads": os.path.join(WORK, "reads.fa"),
    }
    write_dataset(
        paths["reads"], {paths["draft"]: False, paths["draft_n"]: True},
        **size,
    )
    for name, path in paths.items():
        say(f"{name}: {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    return paths


def build_index(draft: str):
    from ntlink_jax.index import ContigIndex
    from ntlink_jax.seqio import stream_fastx
    from ntlink_jax.sketch import sketch_sequences

    named = ((r.name, r.seq) for r in stream_fastx(draft))
    index = ContigIndex.from_sketches(
        (n, m) for n, _, m in sketch_sequences(named, K, W, threads=THREADS)
    )
    lengths = {r.name: len(r.seq) for r in stream_fastx(draft)}
    return index, lengths


# -- phase 3 ---------------------------------------------------------------

def show_compiled(label: str, lowered_fn, args) -> None:
    t0 = time.perf_counter()
    compiled = lowered_fn.lower(*args).compile()
    dt = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    stats = " ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(mem, f, 0) / 2**20:.1f}MiB"
        for f in fields
    )
    say(f"compile {label}: {dt:.2f} s; memory_analysis: {stats}")


def compile_steps(index, clen, read_pad: int, contig_len: int) -> None:
    """Compile every single-card step variant at the shapes the run uses:
    read batches of the 16 kb bucket and contig batches of the draft's
    bucket (mirrors DeviceMapper._step_for / JaxSketcher.sketch_stream)."""
    import jax
    import jax.numpy as jnp

    from ntlink_jax.device_map import DeviceMapper, _single_device_step
    from ntlink_jax.ops.sketch_jax import JaxSketcher, _sketch_step
    from ntlink_jax.stream_pipeline import next_pow2

    u8, i32 = jnp.uint8, jnp.int32
    S = jax.ShapeDtypeStruct
    for runs_only in (True, False):
        dm = DeviceMapper(index, K, W, with_hashes=False,
                          prechain=(clen, Z), runs_only=runs_only)
        L = read_pad
        B = next_pow2(max(1, dm.batch_bases // L))
        d = dm.didx
        pack = d.t_off is not None
        t_off = d.t_off if pack else jnp.zeros(1, jnp.uint32)
        base = (S((B, L // 4), u8), S((B,), i32), d.t_bkt, t_off,
                dm._clen_dev, K, W, L, d.mask, d.max_probes,
                dm._slots_for(L), False, pack, True, Z, runs_only)
        name = "runs-only" if runs_only else "verbose anchors"
        show_compiled(f"map {name} B={B} L={L}", _single_device_step(), base)
        if not runs_only:
            show_compiled(
                f"map N-mask B={B} L={L}", _single_device_step(),
                base + (S((B, L // 8), u8),),
            )
    sk = JaxSketcher()
    L = sk._pad_len(contig_len)
    B = 1
    while B < max(1, sk.batch_bases // L):
        B <<= 1
    sargs = (S((B, L // 4), u8), S((B,), i32), K, W, L, sk._slots_for(L, W))
    show_compiled(f"sketch B={B} L={L}", _sketch_step(), sargs)
    show_compiled(f"sketch N-mask B={B} L={L}", _sketch_step(),
                  sargs + (S((B, L // 8), u8),))


def reference_raw(index, chainer, codes, runs_only: bool):
    """The host path's answer for one read: NumPy sketch, sorted-index
    lookup, C chain (the device path must match it exactly)."""
    import numpy as np

    from ntlink_jax.ops import nthash_np

    mins = nthash_np.sketch_codes(codes, K, W)
    found, cid, cpos, cstrand = index.lookup_many(mins.hashes)
    rpos = np.ascontiguousarray(mins.positions[found].astype(np.int32))
    cid = np.ascontiguousarray(cid[found].astype(np.int32))
    cpos = np.ascontiguousarray(cpos[found].astype(np.int32))
    sbits = np.ascontiguousarray(
        cstrand[found].astype(np.int32)
        | (mins.forward[found].astype(np.int32) << 1)
    )
    if runs_only:
        runs_b, _, _, _ = chainer.chain_batch(
            cid, cpos, rpos, sbits, np.array([0, len(cid)], np.int64),
            np.array([len(codes)], np.int32), None, K, Z, 0, 0.0, 0, 0,
        )
        return np.frombuffer(runs_b, np.int32).reshape(-1, 8)
    sel = np.frombuffer(
        chainer.chain_select(cid, cpos, rpos, sbits, len(codes), K, Z, 0, 0.0),
        np.int32,
    )
    return np.stack([rpos[sel], cid[sel], cpos[sel], sbits[sel]])


def check_batch(index, clen, reads_path: str) -> None:
    """One real batch through the mapping step, in each payload form, read
    for read against reference_raw; the N-mask variant on the same reads
    with an N run planted in every third read."""
    import numpy as np

    from ntlink_jax.device_map import DeviceMapper
    from ntlink_jax.native import chain_module
    from ntlink_jax.ops import nthash_np
    from ntlink_jax.seqio import stream_fastx

    reads = []
    for rec in stream_fastx(reads_path):
        reads.append((rec.name, nthash_np.encode(rec.seq)))
        if len(reads) == BATCH_READS:
            break
    with_n = []
    for i, (name, codes) in enumerate(reads):
        if i % 3 == 0:
            codes = codes.copy()
            codes[1000:1060] = 4
        with_n.append((name, codes))
    chainer = chain_module().Chainer(clen, index.contig_names)
    for label, batch, runs_only in (
        ("runs-only", reads, True),
        ("verbose anchors", reads, False),
        ("N-mask anchors", with_n, False),
    ):
        dm = DeviceMapper(index, K, W, with_hashes=False, prechain=(clen, Z),
                          runs_only=runs_only)
        n_anchors = 0
        for (name, codes), (gname, glen, raw) in zip(
            batch, dm.map_stream_raw(iter(batch))
        ):
            assert gname == name and glen == len(codes), (name, gname)
            want = reference_raw(index, chainer, codes, runs_only)
            if runs_only:
                got = (np.zeros((0, 8), np.int32) if raw is None
                       else np.asarray(raw[1]))
            else:
                got = (np.zeros((4, 0), np.int32) if raw is None
                       else np.stack([np.asarray(a) for a in raw[1:5]]))
            if not np.array_equal(got, want):
                raise AssertionError(f"{label}: read {name} differs")
            n_anchors += want.shape[0] if runs_only else want.shape[1]
        if dm.host_fallbacks:
            raise AssertionError(
                f"{label}: {dm.host_fallbacks} read(s) left the device"
            )
        unit = "runs" if runs_only else "anchors"
        say(f"batch {label}: {len(batch)} reads, {n_anchors} {unit}, "
            f"identical to nthash_np + C chain")


# -- phase 4 ---------------------------------------------------------------

TARGETS = {
    "pair": (["pair"], "draft", ["verbose=False"]),
    "scaffold gap_fill": (["scaffold", "gap_fill"], "draft", []),
    "run_rounds rounds=2": (["run_rounds"], "draft_n", ["rounds=2"]),
}


def run_cli(label: str, workdir: str, argv) -> dict:
    """One CLI run in its own directory; returns wall time and the run's
    tracer counters. The run's own output goes to <workdir>/run.log."""
    from ntlink_jax import cli, tracing

    tracing.GLOBAL.spans.clear()
    tracing.GLOBAL.counters.clear()
    log = os.path.join(workdir, "run.log")
    cwd = os.getcwd()
    os.chdir(workdir)
    t0 = time.perf_counter()
    try:
        with open(log, "w") as fh, contextlib.redirect_stdout(fh):
            rc = cli.main(argv)
    except BaseException:
        with open(log) as fh:
            say("".join(fh.readlines()[-40:]))
        raise
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{label}: exit code {rc}")
    spans = {s.name: s.wall_s for s in tracing.GLOBAL.spans}
    return {"wall": wall, "map_s": spans.get("pair/map-reads"),
            **tracing.GLOBAL.counters}


def compare_dirs(a: str, b: str) -> int:
    """Every artifact of `a` and `b` byte-identical (symlinks: same
    target); the run's own log and trace are not artifacts."""
    skip = lambda f: f == "run.log" or f.endswith(".trace.json")
    fa = sorted(f for f in os.listdir(a) if not skip(f))
    fb = sorted(f for f in os.listdir(b) if not skip(f))
    if fa != fb:
        raise AssertionError(
            f"artifact sets differ: {sorted(set(fa) ^ set(fb))}"
        )
    for f in fa:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if os.path.islink(pa) or os.path.islink(pb):
            same = os.readlink(pa) == os.readlink(pb)
        else:
            same = filecmp.cmp(pa, pb, shallow=False)
        if not same:
            raise AssertionError(f"cmp: {f} differs")
    return len(fa)


def end_to_end(paths, targets, device_variants, n_reads: int) -> None:
    import jax

    for label in targets:
        cli_targets, draft_key, extra = TARGETS[label]
        slug = label.replace(" ", "_").replace("=", "")
        ref_dir = None
        for variant, knobs in [("numpy", ["backend=numpy"])] + device_variants:
            d = os.path.join(WORK, slug, variant)
            os.makedirs(d)
            shutil.copy(paths[draft_key], os.path.join(d, "draft.fa"))
            argv = cli_targets + [
                "target=draft.fa", f"reads={paths['reads']}", f"k={K}",
                f"w={W}", f"z={Z}", f"t={THREADS}", "v=1", *extra, *knobs,
            ]
            r = run_cli(f"{label} [{variant}]", d, argv)
            rate = (f"{n_reads / r['map_s']:.0f} reads/s mapping"
                    if r.get("map_s") else "mapping from checkpoint")
            say(f"{label} [{variant}]: wall {r['wall']:.1f} s, {rate}")
            if variant == "numpy":
                ref_dir = d
                continue
            mapped = r.get("map/reads", 0)
            on_dev = r.get("map/device_reads", 0)
            share = on_dev / mapped if mapped else 0.0
            peaks = [
                (dv.memory_stats() or {}).get("peak_bytes_in_use", 0)
                for dv in jax.local_devices()
            ]
            say(f"  device-mapped reads {on_dev}/{mapped} ({share:.4%}); "
                f"DeviceMapper.host_fallbacks="
                f"{r.get('map/device_host_fallbacks', 0)}")
            say(f"  sketch: device rows {r.get('sketch/device_rows', 0)}, "
                f"host fallback rows {r.get('sketch/host_fallbacks', 0)}; "
                f"hybrid sketcher device_seqs/host_seqs: not used "
                f"(backend=jax sketches on the device alone)")
            say("  peak_bytes_in_use: "
                + ", ".join(f"{p / 2**30:.2f} GiB" for p in peaks))
            if share <= 0.99:
                raise AssertionError(
                    f"{label} [{variant}]: only {share:.2%} of reads "
                    f"mapped on the device"
                )
            if r.get("sketch/device_rows", 0) == 0:
                raise AssertionError(
                    f"{label} [{variant}]: the draft was not sketched on "
                    f"the device"
                )
            n = compare_dirs(ref_dir, d)
            say(f"  cmp vs numpy: {n} artifacts byte-identical")


# -- main ------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU; prints no result line")
    args = ap.parse_args()

    # pin the platform before JAX is imported: a missing or broken CUDA
    # plugin must fail here, not fall back to the CPU
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cards}"
        ).strip()
    else:
        os.environ["JAX_PLATFORMS"] = "cuda"
        if args.cards == 1:
            os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    sys.path.insert(0, ROOT)
    size = SIZES["rehearse" if args.rehearse else "full"]

    t_all = time.perf_counter()
    t0 = phase("1. environment")
    devs = environment(args)
    done(t0)

    t0 = phase("2. data")
    paths = make_data(size)
    index, lengths = build_index(paths["draft"])
    say(f"index: {len(index)} minimizers over {len(index.contig_names)} "
        f"contigs")
    done(t0)

    if args.cards == 1:
        import numpy as np

        clen = np.array([lengths[n] for n in index.contig_names], np.int32)
        t0 = phase("3. steps")
        compile_steps(index, clen, 1 << 14, size["contig_len"])
        check_batch(index, clen, paths["reads"])
        done(t0)
        t0 = phase("4. end to end")
        end_to_end(paths, list(TARGETS), [("jax", ["backend=jax"])],
                   size["n_reads"])
    else:
        t0 = phase("4. end to end on four cards")
        end_to_end(
            paths, ["pair"],
            [("jax-replicated", ["backend=jax"]),
             ("jax-hash", ["backend=jax", "index_sharding=hash",
                           "idx_shards=4"])],
            size["n_reads"],
        )
    done(t0)
    shutil.rmtree(WORK, ignore_errors=True)
    say(f"\nall phases passed in {time.perf_counter() - t_all:.1f} s")
    if args.rehearse:
        say("rehearsal passed (no result line on the CPU)")
        return 0
    d0 = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        rc = 1
    sys.stdout.flush()
    os._exit(rc)
