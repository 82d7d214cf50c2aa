"""Pipeline stage drivers.

Replaces the reference's Make DAG (reference ntLink:151-271) with in-process
stages sharing one artifact contract: every stage writes the same files, with
the same names and formats, that the reference pipeline produces, and existing
up-to-date artifacts short-circuit their stage (Make-style incrementalism).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

from .config import ScaffoldConfig
from .graphio import graph_from_tally, largest_ntlink_id, write_dot
from .hybrid_map import HybridMapper
from .tracing import GLOBAL as tracer
from .index import ContigIndex
from .mapping import AnchorHit, chain_read_hits
from .pairs import PairTally, tally_from_checkpoint
from .paf import paf_lines
from .seqio import stream_fastx
from .seqio.fastx import prefetch_files
from .sketch import get_backend, sketch_fasta_to_tsv


def log(*parts) -> None:
    print(time.strftime("%Y-%m-%d %H:%M:%S"), "-", *parts, file=sys.stdout, flush=True)


def _is_fresh(output: str, *inputs: str) -> bool:
    """True if `output` exists and is newer than every input (Make semantics)."""
    if not os.path.exists(output):
        return False
    out_mtime = os.path.getmtime(output)
    return all(
        os.path.exists(i) and os.path.getmtime(i) <= out_mtime for i in inputs
    )


def ensure_contig_sketch_tsv(cfg: ScaffoldConfig, k: int, w: int, with_strand=True) -> str:
    """Sketch the target assembly to the reference's TSV artifact."""
    out = f"{cfg.target}.k{k}.w{w}.tsv"
    # size guard: a 0-byte TSV next to a non-empty target is a truncated
    # artifact (pre-tmp-rename versions could leave one on SIGKILL), not
    # a reusable sketch
    if _is_fresh(out, cfg.target) and os.path.getsize(out) > 0:
        log("Reusing sketch", out)
        return out
    log("Sketching", cfg.target, f"(k={k}, w={w})")
    backend = get_backend(cfg.backend, threads=cfg.t)
    sketch_fasta_to_tsv(
        cfg.target, out, k, w, with_strand=with_strand, backend=backend,
        threads=cfg.t,
    )
    if backend is not None:
        for name in ("device_rows", "host_fallbacks", "device_seqs",
                     "host_seqs"):
            if hasattr(backend, name):
                tracer.count(f"sketch/{name}", getattr(backend, name))
    return out


def read_scaffold_lengths(path: str) -> Dict[str, int]:
    return {rec.name: len(rec.seq) for rec in stream_fastx(path)}


def _host_hit_stream_codes(cfg, index, codes_iter):
    """NumPy-backend per-read anchor stream (sketch + dict join on host)."""
    from .ops import nthash_np

    for name, codes in codes_iter:
        mins = nthash_np.sketch_codes(codes, cfg.k, cfg.w)
        mask = index.member_mask(mins.hashes)
        if not mask.any():
            yield name, len(codes), []
            continue
        hits = []
        for h, p, f in zip(
            mins.hashes[mask], mins.positions[mask], mins.forward[mask]
        ):
            entry = index.get(int(h))
            yield_strand = "+" if f else "-"
            hits.append(
                (
                    entry.contig,
                    AnchorHit(int(h), entry.position, entry.strand, int(p), yield_strand),
                )
            )
        yield name, len(codes), hits


def _prechain_args(cfg: ScaffoldConfig, index: ContigIndex, contig_lengths):
    """(clen int32 in contig-id order, z) when the run qualifies for
    pre-chained payloads (chaining acceptance applied inside the mappers:
    on-device for DeviceMapper, in C workers for HostMapper), else None.
    Gated to the default knobs: the repeat filter must run BEFORE
    chaining (host path), sensitive-mode subsume and the x fudge factor
    are host-only (x uses double math whose float semantics the device
    does not replicate bit-exactly)."""
    if (
        contig_lengths is None
        or cfg.repeats
        or cfg.sensitive
        or cfg.x != 0
    ):
        return None
    import numpy as _np

    clen = _np.zeros(len(index.contig_names), dtype=_np.int32)
    for i, nme in enumerate(index.contig_names):
        clen[i] = contig_lengths[nme]
    return clen, cfg.z


def _make_device_mapper(cfg: ScaffoldConfig, index: ContigIndex,
                        contig_lengths=None, runs_only: bool = False):
    """The device mapper, or None for backend=numpy. backend=auto maps on
    the host only when JAX is not installed; any other device error
    propagates, so a broken device never passes for a host run."""
    if cfg.backend == "numpy":
        return None
    try:
        from .device_map import DeviceMapper
    except ImportError as exc:
        if cfg.backend != "auto":
            raise
        log("Device backend unavailable, using NumPy:", exc)
        return None
    mapper = DeviceMapper(
        index, cfg.k, cfg.w, batch_bases=cfg.batch_bases,
        with_hashes=cfg.repeats, index_sharding=cfg.index_sharding,
        idx_shards=cfg.idx_shards,
        prechain=_prechain_args(cfg, index, contig_lengths),
        runs_only=runs_only,
    )
    if cfg.v:
        import jax

        dev = jax.local_devices()[0]
        log(
            f"Mapping on JAX platform {dev.platform} ({dev.device_kind}, "
            f"{mapper.n_devices} device(s), index_sharding="
            f"{mapper.index_sharding})"
        )
    return mapper


def _make_native_chainer(mapper, contig_lengths):
    """Native per-read chaining + verbose rendering (None if unavailable)."""
    from .native import chain_module

    chain_mod = chain_module()
    if chain_mod is None:
        return None
    import numpy as _np

    clen = _np.zeros(len(mapper.contig_names), dtype=_np.int32)
    for name, idx in mapper._contig_order.items():
        clen[idx] = contig_lengths[name]
    return chain_mod.Chainer(clen, mapper.contig_names)


def _write_verbose(fh, name, runs) -> None:
    for run in runs:
        fh.write(
            f"{name}\t{run.contig}\t{run.hit_count}\t{run.hits_string()}\n".encode()
        )


# reads per native chain_batch call: one C crossing + one verbose write per
# group instead of per read. Sized to roughly one device batch so the C
# chaining + tally of batch N overlap the wire/device time of batches N+1..
# (map_stream_raw yields each read as soon as its batch drains); still large
# enough that the per-call overhead is negligible (~1k reads x ~150 anchors
# x 16 B ~= 2.5 MB per call)
CHAIN_GROUP = 1024


def _repeat_filter_batch(np, offs, arrays, hi, lo):
    """Vectorized per-read repeat filter: drop every anchor whose 64-bit
    hash occurs more than once within its read's matched anchors
    (reference ntlink_pair.py:368-374). Returns (new_offs, new_arrays)."""
    total = int(offs[-1])
    n_g = len(offs) - 1
    rid = np.repeat(np.arange(n_g, dtype=np.int64), np.diff(offs))
    order = np.lexsort((lo, hi, rid))
    sh, sl, sr = hi[order], lo[order], rid[order]
    same_prev = np.zeros(total, bool)
    same_prev[1:] = (sr[1:] == sr[:-1]) & (sh[1:] == sh[:-1]) & (
        sl[1:] == sl[:-1]
    )
    dup_sorted = same_prev.copy()
    dup_sorted[:-1] |= same_prev[1:]
    keep = np.empty(total, bool)
    keep[order] = ~dup_sorted
    new_offs = np.zeros(n_g + 1, np.int64)
    np.cumsum(np.bincount(rid[keep], minlength=n_g), out=new_offs[1:])
    return new_offs, [a[keep] for a in arrays]


def _map_reads_native(cfg, mapper, chainer, tally, contig_lengths, verbose_fh,
                      paf_fh):
    """Hot loop: device batches + one C chain_batch call per read group.

    Zero per-anchor Python anywhere; per-read Python is one list append.
    Only reads producing >= 2 accepted runs surface as Python objects (the
    pair tally is a no-op below that; reference ntlink_pair.py:416-435).
    Verbose/PAF rendering and the repeat filter all run batch-level (C /
    NumPy), so paf=True and repeats=True stay on this path.
    """
    import numpy as np

    from .mapping import AnchorHit as AH, RunView
    from .seqio.fastx import stream_codes

    names = mapper.contig_names
    n_reads = 0
    g_names: list = []
    g_lens: list = []
    g_raw: list = []
    mode = (1 if verbose_fh else 0) | (2 if paf_fh else 0)

    def flush_group() -> None:
        if not g_names:
            return
        n_g = len(g_names)
        offs = np.zeros(n_g + 1, np.int64)
        for i, raw in enumerate(g_raw):
            offs[i + 1] = offs[i] + (raw[0] if raw is not None else 0)
        total = int(offs[-1])
        cid = np.empty(total, np.int32)
        cpos = np.empty(total, np.int32)
        rpos = np.empty(total, np.int32)
        sbits = np.empty(total, np.int32)
        if cfg.repeats:
            hi = np.empty(total, np.int32)
            lo = np.empty(total, np.int32)
        for i, raw in enumerate(g_raw):
            if raw is None:
                continue
            o, n = int(offs[i]), raw[0]
            rpos[o : o + n] = raw[1]
            cid[o : o + n] = raw[2]
            cpos[o : o + n] = raw[3]
            sbits[o : o + n] = raw[4]
            if cfg.repeats:
                hi[o : o + n] = raw[5]
                lo[o : o + n] = raw[6]
        if cfg.repeats and total:
            offs, (cid, cpos, rpos, sbits) = _repeat_filter_batch(
                np, offs, (cid, cpos, rpos, sbits), hi, lo
            )
        rlens = np.asarray(g_lens, np.int32)
        # pre-chained mappers (on-device chaining / chain_select workers)
        # deliver ACCEPTED anchors in final order: chain_batch only groups
        # consecutive cids and renders — no filters re-run
        runs_b, ro_b, vbytes, pbytes = chainer.chain_batch(
            np.ascontiguousarray(cid), np.ascontiguousarray(cpos),
            np.ascontiguousarray(rpos), np.ascontiguousarray(sbits),
            offs, rlens,
            g_names if mode else None,
            cfg.k, cfg.z, 1 if cfg.sensitive else 0, float(cfg.x), mode,
            1 if getattr(mapper, "prechained", False) else 0,
        )
        if verbose_fh and vbytes:
            verbose_fh.write(vbytes)
        if paf_fh and pbytes:
            paf_fh.write(pbytes)
        runs_arr = np.frombuffer(runs_b, np.int32).reshape(-1, 8)
        ro = np.frombuffer(ro_b, np.int32)
        for i in np.nonzero(np.diff(ro) >= 2)[0]:
            runs = [
                RunView(
                    names[int(row[0])],
                    int(row[1]),
                    AH(0, int(row[2]), "+" if row[4] & 1 else "-",
                       int(row[3]), "+" if row[4] & 2 else "-"),
                    AH(0, int(row[5]), "+" if row[7] & 1 else "-",
                       int(row[6]), "+" if row[7] & 2 else "-"),
                )
                for row in runs_arr[ro[i] : ro[i + 1]]
            ]
            tally.add_read(runs, int(rlens[i]))
        g_names.clear()
        g_lens.clear()
        g_raw.clear()

    # parallel decompression: up to cfg.t read files parse concurrently on
    # background threads (pigz-equivalent; file order preserved for the
    # order-sensitive verbose/tally artifacts)
    for reads_file, codes_iter in prefetch_files(
        cfg.reads, stream_codes, threads=cfg.t
    ):
        log("Mapping reads", reads_file, "(native batch chain)")
        for name, read_len, raw in mapper.map_stream_raw(codes_iter):
            n_reads += 1
            g_names.append(name)
            g_lens.append(read_len)
            g_raw.append(raw)
            if len(g_names) >= CHAIN_GROUP:
                flush_group()
        flush_group()
    return n_reads


def _map_reads_runs(cfg, mapper, tally):
    """Runs-only hot loop: the mappers ship per-run summary rows [cid,
    count, f_cpos, f_rpos, f_sbits, l_cpos, l_rpos, l_sbits] (chaining
    already applied on-device / in C workers), so the consumer does no
    chaining at all — single-run reads are a pure counter bump and only
    multi-run reads build Python objects (the pair tally is a no-op below
    2 runs; reference ntlink_pair.py:416-435). No verbose/PAF here: those
    need per-anchor payloads (map_reads gates)."""
    from .mapping import AnchorHit as AH, RunView
    from .seqio.fastx import stream_codes

    names = mapper.contig_names
    n_reads = 0
    for reads_file, codes_iter in prefetch_files(
        cfg.reads, stream_codes, threads=cfg.t
    ):
        log("Mapping reads", reads_file, "(runs-only payload)")
        for name, read_len, raw in mapper.map_stream_raw(codes_iter):
            n_reads += 1
            if raw is None or raw[0] < 2:
                continue
            runs = [
                RunView(
                    names[r0],
                    r1,
                    AH(0, r2, "+" if r4 & 1 else "-",
                       r3, "+" if r4 & 2 else "-"),
                    AH(0, r5, "+" if r7 & 1 else "-",
                       r6, "+" if r7 & 2 else "-"),
                )
                for r0, r1, r2, r3, r4, r5, r6, r7 in raw[1].tolist()
            ]
            tally.add_read(runs, read_len)
    return n_reads


def _map_reads_generic(cfg, mapper, index, tally, contig_lengths,
                       verbose_fh, paf_fh):
    """General path: per-hit objects (needed for PAF output / repeat filter)."""
    from .seqio.fastx import stream_codes

    n_reads = 0
    for reads_file, codes_iter in prefetch_files(
        cfg.reads, stream_codes, threads=cfg.t
    ):
        log("Mapping reads", reads_file)
        if mapper is not None:
            hit_stream = mapper.map_stream(codes_iter)
        else:
            hit_stream = _host_hit_stream_codes(cfg, index, codes_iter)
        for name, read_len, hits in hit_stream:
            n_reads += 1
            if not hits:
                continue
            if cfg.repeats:
                # drop every occurrence of a hash matched more than once
                # within this read (reference ntlink_pair.py:368-374)
                counts: Dict[int, int] = {}
                for _, h in hits:
                    counts[h.mx] = counts.get(h.mx, 0) + 1
                hits = [(c, h) for c, h in hits if counts[h.mx] == 1]
            if not hits:
                continue
            runs = chain_read_hits(
                hits, read_len, contig_lengths, cfg.k, cfg.z,
                x=cfg.x, sensitive=cfg.sensitive,
            )
            if not runs:
                continue
            if verbose_fh:
                _write_verbose(verbose_fh, name, runs)
            if paf_fh:
                for line in paf_lines(runs, name, read_len, contig_lengths, cfg.k):
                    paf_fh.write((line + "\n").encode())
            tally.add_read(runs, read_len)
    return n_reads


def map_reads(
    cfg: ScaffoldConfig,
    index: ContigIndex,
    contig_lengths: Dict[str, int],
    verbose_path: Optional[str],
    paf_path: Optional[str],
    tally: Optional[PairTally] = None,
    mapper=None,
) -> PairTally:
    """Stream read files through sketch → match → chain → tally.

    The sketch+match hot loop runs on-device in batches when a JAX backend is
    available (device_map.DeviceMapper), with chaining + verbose/PAF
    rendering in native C and the repeat filter vectorized in NumPy; only
    the NumPy backend (or a failed C build) takes the general object path.
    All paths preserve the reference's exact order-sensitive semantics.
    Pass `tally`/`mapper` to accumulate across calls (per-file multi-host
    sharding) without rebuilding the device index.
    """
    if tally is None:
        tally = PairTally(contig_lengths, cfg.k, cfg.f)
    # crash safety: stream into .tmp and rename only on success, so a
    # killed run can never leave a truncated verbose_mapping.tsv behind —
    # which a rerun would silently trust as a complete mapping checkpoint
    # (the reference only cleans up on catchable exceptions,
    # ntlink_pair.py:608-613; SIGKILL bypasses both there and here)
    verbose_tmp = f"{verbose_path}.tmp" if verbose_path else None
    paf_tmp = f"{paf_path}.tmp" if paf_path else None
    verbose_fh = open(verbose_tmp, "wb") if verbose_path else None
    paf_fh = open(paf_tmp, "wb") if paf_path else None

    if mapper is None:
        mapper = _make_device_mapper(
            cfg, index, contig_lengths,
            # non-verbose/non-PAF runs ship O(runs) summaries instead of
            # per-anchor payloads (~10x less D2H; the pair tally consumes
            # only run endpoints) — the reference's default `pair` config
            # (verbose is opt-in, reference ntLink:204-219)
            runs_only=(verbose_path is None and paf_path is None),
        )
    chainer = None
    if mapper is not None:
        chainer = _make_native_chainer(mapper, contig_lengths)
        if (
            chainer is not None
            and cfg.backend == "hybrid"
            and not isinstance(mapper, HybridMapper)
        ):
            # split the stream across the device and the host C path;
            # output order (hence every artifact byte) is unchanged
            from .host_map import HostMapper

            # full t host threads, not t-1: the device-side threads spend
            # nearly all their time in GIL-released transfer waits, and
            # measured hybrid throughput is higher with the host side fully
            # populated than with a core reserved for the device feed
            mapper = HybridMapper(
                mapper,
                HostMapper(
                    index, cfg.k, cfg.w, threads=max(1, cfg.t),
                    prechain=(
                        _prechain_args(cfg, index, contig_lengths)
                        if getattr(mapper, "prechained", False) else None
                    ),
                    runs_only=getattr(mapper, "runs_only", False),
                ),
                cfg.hybrid_host_frac,
            )
    else:
        # no device (backend=numpy or JAX unavailable): the strongest CPU
        # path — threaded NumPy sketch+join feeding the same native C
        # chain/verbose/PAF batch loop (byte-identical output); falls back
        # to the generic object path only if the C chainer didn't build
        from .host_map import HostMapper

        # host-only: chaining stays on the CONSUMER thread (chain_batch) —
        # it overlaps the workers' sketching there, effectively a 5th
        # compute lane; prechaining in the workers measured ~5% slower.
        # (The hybrid path prechains its host leg because the consumer is
        # busy driving the device and payloads must match the device's.)
        host = HostMapper(index, cfg.k, cfg.w, threads=cfg.t)
        chainer = _make_native_chainer(host, contig_lengths)
        if chainer is not None:
            mapper = host

    fallbacks0 = getattr(mapper, "host_fallbacks", 0)
    try:
        if getattr(mapper, "runs_only", False):
            # O(runs) payloads carry no per-anchor data — incompatible
            # with verbose/PAF rendering by construction (map_reads only
            # builds runs_only mappers when neither is requested)
            if verbose_fh or paf_fh:
                raise ValueError(
                    "runs_only mapper cannot render verbose/PAF artifacts"
                )
            n_reads = _map_reads_runs(cfg, mapper, tally)
        elif chainer is not None:
            n_reads = _map_reads_native(
                cfg, mapper, chainer, tally, contig_lengths, verbose_fh,
                paf_fh
            )
        else:
            n_reads = _map_reads_generic(
                cfg, mapper, index, tally, contig_lengths, verbose_fh, paf_fh
            )
    except Exception:
        # mirror the reference's partial-output cleanup (ntlink_pair.py:608-613)
        for fh, path in ((verbose_fh, verbose_tmp), (paf_fh, paf_tmp)):
            if fh:
                fh.close()
                os.unlink(path)
        raise
    finally:
        for fh in (verbose_fh, paf_fh):
            if fh and not fh.closed:
                fh.close()
    if verbose_path:
        os.replace(verbose_tmp, verbose_path)
    if paf_path:
        os.replace(paf_tmp, paf_path)
    log("Mapped", n_reads, "reads")
    tracer.count("map/reads", n_reads)
    if hasattr(mapper, "n_devices"):  # a DeviceMapper
        host = mapper.host_fallbacks - fallbacks0
        tracer.count("map/device_reads", n_reads - host)
        tracer.count("map/device_host_fallbacks", host)
    return tally


def pair_stage(cfg: ScaffoldConfig) -> str:
    """Mapping + scaffold-graph stage. Returns the DOT artifact path."""
    prefix = cfg.resolved_prefix()
    dot_path = f"{prefix}.n{cfg.n}.scaffold.dot"
    checkpoint = f"{prefix}.verbose_mapping.tsv"

    wanted = [dot_path]
    if cfg.paf:
        wanted.append(f"{prefix}.paf")
    if cfg.pairs_tsv:
        wanted.append(f"{prefix}.pairs.tsv")
    if all(_is_fresh(p, cfg.target, *cfg.reads) for p in wanted):
        log("Reusing scaffold graph", dot_path)
        return dot_path

    contig_lengths = read_scaffold_lengths(cfg.target)

    explicit = cfg.checkpoint
    if explicit or (
        os.path.exists(checkpoint)
        and _is_fresh(checkpoint, cfg.target, *cfg.reads)
    ):
        ckpt = explicit or checkpoint
        log("Found mapping checkpoint", ckpt, "- bypassing read mapping")
        with tracer.stage("pair/checkpoint-tally"):
            tally = tally_from_checkpoint(ckpt, contig_lengths, cfg.k, cfg.f)
    else:
        from .parallel.distributed import (
            all_gather_file_tallies,
            maybe_init_distributed,
            merge_file_parts,
        )

        process_id, n_processes = maybe_init_distributed()
        with tracer.stage("pair/contig-sketch"):
            tsv = ensure_contig_sketch_tsv(cfg, cfg.k, cfg.w)
            log("Loading contig index", tsv)
            index = ContigIndex.from_tsv(tsv)
            log("Index size:", len(index))
        if n_processes > 1:
            # per-read-file sharding: each host maps its files into
            # per-file tallies and artifact parts, then everything merges
            # in global file order — byte-identical to a single-host run
            # (reference contract: one verbose/paf file,
            # ntlink_pair.py:382-388)
            import dataclasses

            mapper = _make_device_mapper(
                cfg, index, contig_lengths,
                runs_only=not (cfg.verbose or cfg.paf),
            )
            per_file_tallies: Dict[int, PairTally] = {}
            verbose_parts: Dict[int, str] = {}
            paf_parts: Dict[int, str] = {}
            with tracer.stage("pair/map-reads"):
                for fi, reads_file in enumerate(cfg.reads):
                    if fi % n_processes != process_id:
                        continue
                    log(f"Host {process_id}/{n_processes} mapping", reads_file)
                    sub = dataclasses.replace(cfg, reads=[reads_file])
                    vp = f"{checkpoint}.part{fi}" if cfg.verbose else None
                    pp = f"{prefix}.paf.part{fi}" if cfg.paf else None
                    per_file_tallies[fi] = map_reads(
                        sub, index, contig_lengths, vp, pp, mapper=mapper
                    )
                    if vp:
                        verbose_parts[fi] = vp
                    if pp:
                        paf_parts[fi] = pp
            with tracer.stage("pair/tally-allgather"):
                tally = all_gather_file_tallies(
                    per_file_tallies, PairTally(contig_lengths, cfg.k, cfg.f)
                )
                if cfg.verbose:
                    merge_file_parts(checkpoint, verbose_parts)
                if cfg.paf:
                    merge_file_parts(f"{prefix}.paf", paf_parts)
        else:
            with tracer.stage("pair/map-reads"):
                tally = map_reads(
                    cfg,
                    index,
                    contig_lengths,
                    verbose_path=checkpoint if cfg.verbose else None,
                    paf_path=f"{prefix}.paf" if cfg.paf else None,
                )

    with tracer.stage("pair/graph-build"):
        tally.filter_distances()
        tally.filter_weak_anchors(cfg.a)
        if cfg.pairs_tsv:
            tally.write_pairs_tsv(f"{prefix}.pairs.tsv")

        graph = graph_from_tally(tally, contig_lengths)
        graph = graph.filtered_by_weight(int(cfg.n))
        write_dot(graph, dot_path, largest_ntlink_id(contig_lengths.keys()))
    log("Wrote scaffold graph", dot_path)
    return dot_path


def layout_and_stitch(cfg: ScaffoldConfig, dot_path: str) -> str:
    """n-sweep layout + optimal-n stitch. Returns the stitch path file."""
    from .graphio import read_dot
    from .layout import run_n_sweep
    from .stitch import stitch

    prefix = cfg.resolved_prefix()
    stitch_path = f"{prefix}.stitch.path"
    if _is_fresh(stitch_path, dot_path, cfg.target):
        log("Reusing stitched paths", stitch_path)
        return stitch_path
    graph = read_dot(dot_path)
    contig_lengths = read_scaffold_lengths(cfg.target)
    log("Layout n-sweep", f"n={cfg.n}..{cfg.max_n}")
    sweep_files = run_n_sweep(
        graph, contig_lengths, cfg.n, cfg.max_n, cfg.z, cfg.g, prefix,
        threads=cfg.t,
    )
    stitch(
        sweep_files,
        graph,
        stitch_path,
        max_gap=cfg.G,
        conservative=cfg.conservative,
    )
    for f in sweep_files:
        os.unlink(f)
        os.unlink(f + ".sterr")
    log("Wrote stitched paths", stitch_path)
    return stitch_path


def scaffold_stage(cfg: ScaffoldConfig) -> str:
    """Full scaffold flow: pair -> layout/stitch -> [overlap trim] -> merge.

    Returns the final scaffolds FASTA path (reference ntLink:151-171).
    """
    from .merge import merge_contigs

    prefix = cfg.resolved_prefix()
    dot_path = pair_stage(cfg)
    with tracer.stage("layout+stitch"):
        stitch_path = layout_and_stitch(cfg, dot_path)

    merged = f"{cfg.target}.k{cfg.k}.w{cfg.w}.z{cfg.z}.stitch.abyss-scaffold.fa"
    if cfg.overlap:
        from .overlap import overlap_stage

        trimmed_fa = f"{prefix}.trimmed_scafs.fa"
        trimmed_path = f"{prefix}.trimmed_scafs.path"
        if _is_fresh(trimmed_fa, stitch_path, dot_path, cfg.target) and _is_fresh(
            trimmed_path, stitch_path
        ):
            log("Reusing trimmed scaffolds", trimmed_fa)
        else:
            with tracer.stage("overlap-trim"):
                trimmed_fa = overlap_stage(cfg, dot_path, stitch_path)
        if _is_fresh(merged, trimmed_fa, trimmed_path):
            log("Reusing merged scaffolds", merged)
        else:
            with tracer.stage("merge"):
                merge_contigs(trimmed_fa, trimmed_path, merged)
    else:
        if _is_fresh(merged, cfg.target, stitch_path):
            log("Reusing merged scaffolds", merged)
        else:
            with tracer.stage("merge"):
                merge_contigs(cfg.target, stitch_path, merged)
    log("Merged scaffolds at", merged)

    final = cfg.out_scaffolds()
    if os.path.islink(final) or os.path.exists(final):
        os.unlink(final)
    os.symlink(os.path.basename(merged), final)
    log("Done! Final post-ntLink scaffolds in:", final)
    return final


def gap_fill_stage(cfg: ScaffoldConfig) -> str:
    """Gap-fill the trimmed layout; re-points the final scaffolds symlink
    at the gap-filled FASTA (reference ntLink:266-271)."""
    from .gapfill import gap_fill_stage as run_gap_fill

    out = run_gap_fill(cfg)
    final = cfg.out_scaffolds()
    if os.path.islink(final) or os.path.exists(final):
        os.unlink(final)
    os.symlink(os.path.basename(out), final)
    log("Done! Final post-ntLink and gap-filled scaffolds in:", final)
    return out


def run_scaffold(cfg: ScaffoldConfig, gap_fill: bool = False) -> str:
    """`ntlink scaffold [gap_fill]` entry point."""
    final = scaffold_stage(cfg)
    if gap_fill:
        if not cfg.overlap:
            raise ValueError("gap_fill requires the overlap trim stage")
        with tracer.stage("gap-fill"):
            final = gap_fill_stage(cfg)
    if tracer.enabled:
        tracer.report()
        tracer.write_json(f"{cfg.resolved_prefix()}.trace.json")
    return final


def clean_artifacts(cfg: ScaffoldConfig, extra: bool = False) -> None:
    """Remove intermediate artifacts (reference ntLink clean/extra_clean)."""
    prefix = cfg.resolved_prefix()
    doomed = [f"{cfg.target}.k{cfg.k}.w{cfg.w}.tsv"]
    if cfg.overlap:
        doomed += [
            f"{prefix}.trimmed_scafs.fa",
            f"{prefix}.trimmed_scafs.tsv",
            f"{prefix}.stitch.path",
        ]
    gap_fill_fa = f"{cfg.target}.k{cfg.k}.w{cfg.w}.z{cfg.z}.ntLink.scaffolds.gap_fill.fa"
    if os.path.exists(gap_fill_fa):
        doomed.append(f"{cfg.target}.k{cfg.k}.w{cfg.w}.z{cfg.z}.stitch.abyss-scaffold.fa")
    if extra:
        if cfg.overlap:
            doomed.append(f"{prefix}.trimmed_scafs.path")
        doomed.append(f"{prefix}.n{cfg.n}.scaffold.dot")
    for path in doomed:
        if os.path.exists(path) or os.path.islink(path):
            os.unlink(path)


def _relink(link: str, target: str) -> None:
    if os.path.islink(link) or os.path.exists(link):
        os.unlink(link)
    os.symlink(target, link)


def run_rounds(cfg: ScaffoldConfig, rounds: int, gap_fill: bool = False) -> str:
    """Iterative rounds with AGP mapping liftover (reference ntLink_rounds).

    Each round scaffolds the previous round's output; from round 2 onward the
    previous mapping is lifted to the new coordinates and consumed as the
    pair stage's checkpoint — sketching and matching run only once.
    """
    import dataclasses

    from .liftover import liftover_mappings

    if cfg.prefix is not None:
        raise ValueError("prefix must be left default when running rounds")
    kwz = f"k{cfg.k}.w{cfg.w}.z{cfg.z}"
    suffix = "ntLink.gap_fill" if gap_fill else "ntLink"

    target = cfg.target
    round_out = None
    for rnd in range(1, rounds + 1):
        round_cfg = dataclasses.replace(cfg, target=target, prefix=None)
        log(f"=== ntLink round {rnd}/{rounds} (target={target})")
        if rnd > 1:
            # liftover previous round's mappings into the new coordinates
            prev_agp = f"{round_out}.agp"
            prev_verbose = f"{round_out}.verbose_mapping.tsv"
            checkpoint = f"{target}.{kwz}.verbose_mapping.tsv"
            liftover_mappings(prev_verbose, prev_agp, checkpoint, cfg.k)
        run_scaffold(round_cfg, gap_fill=gap_fill)

        prefix = round_cfg.resolved_prefix()
        if rnd == 1:
            round_out = f"{target}.{kwz}.{suffix}.fa"
        else:
            # reference stem rules: %.ntLink[.gap_fill].fa from %[.gap_fill].fa
            stem_suffix = ".gap_fill.fa" if gap_fill else ".fa"
            round_out = f"{target[: -len(stem_suffix)]}.{suffix}.fa"
        if gap_fill:
            produced = f"{target}.{kwz}.ntLink.scaffolds.gap_fill.fa"
            _relink(round_out, produced)
            _relink(f"{round_out}.agp", f"{produced}.agp")
        else:
            produced = f"{target}.{kwz}.ntLink.scaffolds.fa"
            _relink(round_out, os.readlink(produced))
            _relink(f"{round_out}.agp", f"{prefix}.trimmed_scafs.agp")
        _relink(
            f"{round_out}.verbose_mapping.tsv", f"{prefix}.verbose_mapping.tsv"
        )
        clean_artifacts(round_cfg, extra=True)
        target = round_out

    final = f"{cfg.target}.{kwz}.{suffix}.{rounds}rounds.fa"
    _relink(final, round_out)
    if gap_fill:
        # reference also links the plain-named rounds alias (ntLink_rounds:91-94)
        _relink(f"{cfg.target}.{kwz}.ntLink.{rounds}rounds.fa", final)
    log("Done ntLink rounds! Final scaffolds in:", final)
    return final
