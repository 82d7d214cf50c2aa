"""Batched device mapping: sketch + index join on-chip, chaining on host.

This is the engine's hot path. Reads stream into padded, length-bucketed
2-bit-packed (B, L/4) batches (4x less host->device traffic); one fused
jitted step per batch unpacks, sketches, compacts the selected minimizers,
joins them against the replicated contig hash table, and compacts matched
anchors — so the device->host transfer is O(anchors). The host then runs the
exact-order chaining/tally stages. Reads with interior N batch on-device too
(every step variant: 1-bit N mask + compacted-window kernel, reference
semantics); reads the device cannot handle exactly (sub-k, oversized, or
minimizer-slot overflow) fall back to the NumPy sketch + dict join,
preserving bit-exact semantics everywhere.

With more than one device, the same step runs sharded over a 1-D data mesh
(rows split across chips, table replicated) — see parallel.mesh.
"""
from __future__ import annotations

import functools
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from .index import ContigIndex
from .mapping import AnchorHit
from .ops import nthash_np


from .stream_pipeline import next_pow2 as _next_pow2


def default_idx_shards(n_devices: int) -> int:
    """Largest power-of-two divisor of the device count (capped at 4):
    make_mesh_2d needs idx_shards | n_devices and the sharded table needs a
    pow2 shard count (e.g. 6 devices -> 2, not 4; 3 devices -> 1)."""
    s = 1
    while s < 4 and n_devices % (s * 2) == 0:
        s *= 2
    return s


#: adaptive flat-transfer caps, keyed (k, w) -> {pad: cap}
_FLAT_CAPS: Dict[tuple, Dict[int, int]] = {}


@functools.lru_cache(maxsize=1)
def _single_device_step():
    """Module-level jitted mapping step: one compile cache shared by every
    DeviceMapper instance (per distinct static shapes/params)."""
    import jax

    from .parallel.mesh import mapping_step_packed

    @functools.partial(
        jax.jit, static_argnums=(5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    )
    def jstep(packed, lengths, t_bkt, t_off, chain_clen,
              k, w, L_, mask, probes, anchors, with_hashes,
              pack_gpos, do_chain, chain_z, emit_runs, nmask=None):
        return mapping_step_packed(
            packed, lengths, t_bkt,
            k, w, L_, mask, probes, anchors,
            with_hashes=with_hashes, nmask=nmask,
            t_off=t_off if pack_gpos else None,
            chain_clen=chain_clen if do_chain else None,
            chain_z=chain_z, emit_runs=emit_runs,
        )

    return jstep


class DeviceMapper:
    MIN_PAD = 1 << 10
    MAX_PAD = 1 << 21

    def __init__(self, index: ContigIndex, k: int, w: int,
                 batch_bases: int = 8_000_000, use_mesh: bool = True,
                 with_hashes: bool = True, index_sharding: str = "replicated",
                 idx_shards: int = 0, prechain=None, runs_only: bool = False):
        from .jax_setup import configure

        configure()
        import jax

        from .parallel.mesh import CHAIN_MAX_CONTIGS, DeviceIndex

        self.index = index
        self.k, self.w = k, w
        self.batch_bases = batch_bases
        index.finalize()
        self.contig_names: List[str] = index.contig_names
        self._contig_order = {n: i for i, n in enumerate(index.contig_names)}
        self.n_devices = len(jax.local_devices()) if use_mesh else 1
        if index_sharding == "hash" and self.n_devices == 1:
            index_sharding = "replicated"  # nothing to shard over
        self.index_sharding = index_sharding
        self.with_hashes = with_hashes
        if index_sharding == "hash":
            from .parallel.sharded_index import (
                ShardedDeviceIndex,
                make_mesh_2d,
            )

            self.idx_shards = idx_shards or default_idx_shards(self.n_devices)
            self.didx = ShardedDeviceIndex.from_contig_index(
                index, self.idx_shards
            )
            self._mesh2d = make_mesh_2d(self.idx_shards)
        else:
            self.didx = DeviceIndex.from_contig_index(index)
        # on-device chaining (SURVEY §7 layer 4): when `prechain` supplies
        # (contig_lengths int32 in contig-id order, z) and the default-knob
        # gates hold, the z/noisy/subsume acceptance stages run inside the
        # fused step and only accepted-run anchors ship; the raw payload is
        # then PRE-CHAINED (pipeline groups consecutive cids, no filters).
        # Gates: replicated index (the 2-D hash-sharded step keeps host
        # chaining), no repeat filter (with_hashes ships hash planes for
        # the host-side filter that must run BEFORE chaining), and a
        # bounded contig count (the noisy-span scatter tables are
        # per-(read, contig)).
        self.prechained = False
        self._clen_dev = None
        self._chain_z = 0
        self._chain_sel = None
        if (
            prechain is not None
            and index_sharding != "hash"
            and not with_hashes
            and len(index.contig_names) <= CHAIN_MAX_CONTIGS
        ):
            from .native import chain_module

            cm = chain_module()
            if cm is not None:  # exact host selection for fallback rows
                import jax.numpy as jnp

                clen_arr, z = prechain
                clen_np = np.ascontiguousarray(clen_arr, dtype=np.int32)
                self._clen_dev = jnp.asarray(clen_np)
                self._chain_z = int(z)
                self._chain_sel = cm.Chainer(clen_np, index.contig_names)
                self.prechained = True
        # runs-only payload (non-verbose/non-PAF runs): the step ships
        # O(runs) summaries (mesh.summarize_runs_device) instead of
        # per-anchor planes — ~10x less D2H on the dominant direction.
        # Requires the on-device chaining stage (prechained).
        self.runs_only = bool(runs_only) and self.prechained
        self._steps: Dict[Tuple[int, int], object] = {}
        # observed-anchor-volume cap per pad bucket (process-wide so warmup
        # teaches later mapper instances); see drain(). Runs-mode volumes
        # are ~10x smaller, so they learn their own cap table.
        self._flat_caps = _FLAT_CAPS.setdefault(
            (k, w, "runs") if self.runs_only else (k, w), {}
        )
        # reads that bypassed the device (sub-k, > MAX_PAD, or slot
        # overflow) and re-mapped on the single-threaded exact host path
        self.host_fallbacks = 0
        # actual bytes moved over the host<->device link (packed codes +
        # masks + lengths up; meta + flat anchor payload down) AND the
        # seconds each stream thread actually spent blocked in those
        # transfers ("h2d_s" on the feeder's puts, "d2h_s" on the
        # drainer's meta/flat waits) — powers the honest wire-ceiling
        # analysis in bench.py (rates come from the run's own transfers,
        # never from a one-shot probe)
        self.wire_stats = {"h2d": 0, "d2h": 0, "h2d_s": 0.0, "d2h_s": 0.0}

    def _slots_for(self, L: int) -> int:
        """Minimizer slot budget for padded length L (density ~2/(w+1))."""
        return _next_pow2(max(128, int(2.5 * L / (self.w + 1)) + 64))

    def _step_for(self, L: int):
        key = (L, self._slots_for(L))
        if key in self._steps:
            return self._steps[key]
        from .parallel.mesh import make_mesh, make_sharded_mapping_step

        if self.index_sharding == "hash":
            from .parallel.sharded_index import make_sharded_index_mapping_step

            step = make_sharded_index_mapping_step(
                self._mesh2d, self.didx, self.k, self.w, L, key[1],
                with_hashes=self.with_hashes,
            )
        elif self.n_devices > 1:
            step = make_sharded_mapping_step(
                make_mesh(), self.k, self.w, L, self.didx.mask,
                self.didx.max_probes, key[1], with_hashes=self.with_hashes,
                chain_clen=self._clen_dev if self.prechained else None,
                chain_z=self._chain_z, emit_runs=self.runs_only,
            )
        else:
            import jax.numpy as jnp

            jstep = _single_device_step()
            d = self.didx
            pack = d.t_off is not None
            t_off = d.t_off if pack else jnp.zeros(1, jnp.uint32)
            clen = (
                self._clen_dev if self.prechained
                else jnp.zeros(1, jnp.int32)
            )
            step = lambda packed, lengths, didx, nmask=None: jstep(
                packed, lengths, d.t_bkt, t_off, clen,
                self.k, self.w, L, d.mask, d.max_probes, key[1],
                self.with_hashes, pack, self.prechained, self._chain_z,
                self.runs_only, nmask,
            )
        self._steps[key] = step
        return step

    # -- host fallback ----------------------------------------------------

    def _host_map_raw(self, codes: np.ndarray):
        """Host fallback producing the raw array payload (exact path):
        native C rolling sketcher when built, NumPy otherwise.

        Counted per-mapper (`host_fallbacks`); a summary line is printed at
        stream end so a fallback-heavy run (e.g. many ultra-long reads over
        MAX_PAD) is visible instead of just mysteriously slow."""
        self.host_fallbacks += 1
        from .native import sketch_module
        from .ops.nthash_np import Minimizers

        sm = sketch_module()
        if sm is not None:
            _, hb, pb, fb = sm.sketch(
                np.ascontiguousarray(codes), self.k, self.w
            )
            mins = Minimizers(
                np.frombuffer(hb, np.uint64),
                np.frombuffer(pb, np.int64),
                np.frombuffer(fb, np.uint8).astype(bool),
            )
        else:
            mins = nthash_np.sketch_codes(codes, self.k, self.w)
        found, cid, cpos, cstrand = self.index.lookup_many(mins.hashes)
        if not found.any():
            return None
        hashes = mins.hashes[found]
        n = int(hashes.shape[0])
        rpos = mins.positions[found].astype(np.int32)
        sbits = (
            cstrand[found].astype(np.int32)
            | (mins.forward[found].astype(np.int32) << 1)
        )
        hi = (hashes >> np.uint64(32)).astype(np.uint32).view(np.int32)
        lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        rpos = np.ascontiguousarray(rpos)
        cid = np.ascontiguousarray(cid[found].astype(np.int32))
        cpos = np.ascontiguousarray(cpos[found].astype(np.int32))
        sbits = np.ascontiguousarray(sbits)
        if self.runs_only:
            # payload contract is per-RUN summaries: run the full exact C
            # chain and keep only the run rows (chain.c row layout [cid,
            # count, f_cpos, f_rpos, f_sbits, l_cpos, l_rpos, l_sbits])
            runs_b, _, _, _ = self._chain_sel.chain_batch(
                cid, cpos, rpos, sbits,
                np.array([0, n], np.int64),
                np.array([len(codes)], np.int32),
                None, self.k, self._chain_z, 0, 0.0, 0, 0,
            )
            rr = np.frombuffer(runs_b, np.int32).reshape(-1, 8)
            if rr.shape[0] == 0:
                return None
            return (rr.shape[0], rr)
        if self.prechained:
            # the payload contract for this mapper is PRE-CHAINED anchors
            # (on-device chaining) — apply the identical acceptance stages
            # exactly in C for fallback rows
            sel = np.frombuffer(
                self._chain_sel.chain_select(
                    cid, cpos, rpos, sbits,
                    len(codes), self.k, self._chain_z, 0, 0.0,
                ),
                np.int32,
            )
            n = len(sel)
            if n == 0:
                return None
            rpos, cid, cpos, sbits = (
                np.ascontiguousarray(rpos[sel]),
                np.ascontiguousarray(cid[sel]),
                np.ascontiguousarray(cpos[sel]),
                np.ascontiguousarray(sbits[sel]),
            )
            hi = np.ascontiguousarray(hi[sel])
            lo = np.ascontiguousarray(lo[sel])
        return (n, rpos, cid, cpos, sbits, hi, lo)

    def _pad_len(self, n: int) -> int:
        p = self.MIN_PAD
        while p < n and p < self.MAX_PAD:
            p <<= 1
        return p

    def map_stream(
        self, named_seqs: Iterable[Tuple[str, str]]
    ) -> Iterator[Tuple[str, int, List[Tuple[str, AnchorHit]]]]:
        """Yield (read_name, read_len, [(contig, AnchorHit)...]) in order."""
        assert not self.runs_only, "runs-only payloads have no per-hit view"
        names = self.contig_names
        for name, length, raw in self.map_stream_raw(named_seqs):
            if raw is None:
                yield name, length, []
                continue
            n, rpos, cid, cpos, sbits, hi, lo = raw
            hits = [
                (
                    names[c],
                    AnchorHit(
                        h,
                        p,
                        "+" if b & 1 else "-",
                        r,
                        "+" if b & 2 else "-",
                    ),
                )
                for r, c, p, b, h in zip(
                    rpos[:n].tolist(),
                    cid[:n].tolist(),
                    cpos[:n].tolist(),
                    sbits[:n].tolist(),
                    (
                        (hi[:n].view(np.uint32).astype(np.uint64) << np.uint64(32))
                        | lo[:n].view(np.uint32).astype(np.uint64)
                    ).tolist(),
                )
            ]
            yield name, length, hits

    def map_stream_raw(
        self, named_seqs: Iterable[Tuple[str, str]]
    ):
        """Yield (read_name, read_len, raw) where raw is None or
        (n, rpos, cid, cpos, sbits, mx_hi, mx_lo) — contiguous int32/uint32
        array slices, no per-hit Python objects."""
        import jax
        import jax.numpy as jnp

        from .parallel.mesh import pack_codes

        pending: List[Tuple[str, int]] = []   # (name, length)
        results: Dict[int, list] = {}
        encoded: Dict[int, np.ndarray] = {}
        buckets: Dict[tuple, List[int]] = {}  # (pad, has_n) -> read idxs
        next_yield = [0]  # front of the in-order delivery window

        import os
        import time as time_mod

        from .native import fastx_module

        native = fastx_module()

        # NTLINK_TIMING=1: per-phase wall-clock accounting of the hot loop,
        # printed to stderr when the stream closes (main-thread flush phases
        # vs drain-thread transfer waits — shows where a batch actually
        # spends its time)
        timing_on = bool(os.environ.get("NTLINK_TIMING"))
        tacc: Dict[str, float] = {}
        tN: Dict[str, int] = {}

        def _t(key: str, t0: float) -> None:
            tacc[key] = tacc.get(key, 0.0) + (time_mod.perf_counter() - t0)
            tN[key] = tN.get(key, 0) + 1

        # feeder + drainer threads decouple the main thread from every
        # device interaction (see stream_pipeline.DevicePipeline); FIFO
        # order end to end, the queue depth bounds device memory
        # (backpressure).
        from .stream_pipeline import (
            DevicePipeline,
            finish_fused_stream,
            split_n_rows,
            start_fused_stream,
        )

        def flush_bucket(key: tuple, idxs: List[int]) -> None:
            pad, has_n = key
            B = max(
                self.n_devices,
                _next_pow2(max(1, self.batch_bases // pad)),
            )
            assert len(idxs) <= B
            # partial flushes (stream end, budget flush) step the batch
            # height down by powers of two instead of padding to the full
            # height: a 46-read tail in a 1024-row bucket otherwise ships
            # 978 rows of zeros to the device. <= log2(B) extra compiles
            # per bucket, cached persistently. Heights stay at least 8 rows
            # (bounding the tail shapes to compile) and multiples of the
            # device count (data sharding).
            dev_q = max(8, self.n_devices)
            while (
                B > dev_q
                and B // 2 >= len(idxs)
                and (B // 2) % dev_q == 0
            ):
                B //= 2
            row_codes = [encoded.pop(i) for i in idxs]
            lengths = np.zeros(B, dtype=np.int32)
            lengths[: len(idxs)] = [len(c) for c in row_codes]
            rows = dict(enumerate(idxs))
            t0 = time_mod.perf_counter() if timing_on else 0.0
            nmask = None
            row_codes_pack = row_codes
            if has_n:
                row_codes_pack, nmask = split_n_rows(row_codes, B, pad)
            if native is not None:
                buf = native.pack_batch(row_codes_pack, pad)
                packed = np.frombuffer(buf, dtype=np.uint8).reshape(-1, pad // 4)
                if packed.shape[0] < B:
                    packed = np.vstack(
                        [packed, np.zeros((B - packed.shape[0], pad // 4), np.uint8)]
                    )
            else:
                codes = np.zeros((B, pad), dtype=np.uint8)
                for row, c in enumerate(row_codes_pack):
                    codes[row, : len(c)] = c
                packed = pack_codes(codes)
            if timing_on:
                _t("pack", t0)
                t0 = time_mod.perf_counter()
            pipe.submit((packed, nmask, lengths, pad, rows, row_codes))
            if timing_on:
                _t("feed_enqueue_wait", t0)

        def dispatch_batch(packed, nmask, lengths, pad, rows, row_codes) -> None:
            # feeder thread: every device call for this batch (the main
            # thread never blocks on a device round trip)
            t0 = time_mod.perf_counter() if timing_on else 0.0
            step = self._step_for(pad)
            self.wire_stats["h2d"] += (
                packed.nbytes + lengths.nbytes
                + (nmask.nbytes if nmask is not None else 0)
            )
            tw = time_mod.perf_counter()
            dev_packed = jnp.asarray(packed)
            dev_lengths = jnp.asarray(lengths)
            self.wire_stats["h2d_s"] += time_mod.perf_counter() - tw
            if timing_on:
                _t("h2d_put", t0)
                t0 = time_mod.perf_counter()
            if nmask is None:
                out = step(dev_packed, dev_lengths, self.didx)  # async dispatch
            else:  # N batch: every step variant accepts the mask
                out = step(
                    dev_packed, dev_lengths, self.didx, jnp.asarray(nmask)
                )
            if timing_on:
                _t("dispatch", t0)
                t0 = time_mod.perf_counter()
            # adaptive capped-transfer protocol: the payload prefix (meta
            # packed in flat row 0 — ONE object, plus the uint16 rpos
            # stream when present) starts streaming now, async
            sliced = start_fused_stream(
                out, self._flat_caps, pad, int(lengths.shape[0]),
                stats=self.wire_stats,
            )
            if timing_on:
                _t("slice_copyasync", t0)
                t0 = time_mod.perf_counter()
            pipe.submit_drain((out, sliced, pad, rows, row_codes, lengths))
            if timing_on:
                _t("drain_enqueue_wait", t0)

        def drain(out, sliced, pad, rows, row_codes, lengths) -> None:
            B = int(lengths.shape[0])
            pack = getattr(self.didx, "t_off", None) is not None
            t0 = time_mod.perf_counter() if timing_on else 0.0
            count, n_mins, offs, total, planes, r16 = finish_fused_stream(
                out, sliced, B, int((lengths > 0).sum()),
                self._flat_caps, pad, stats=self.wire_stats,
                floor=512 if self.runs_only else 4096,
            )
            if timing_on:
                _t("drain_flat_wait", t0)
            slots = int(out["flat"].shape[1]) // B
            if self.runs_only:
                # O(runs) payload (see mesh.summarize_runs_device): decode
                # to the chain.c run-row layout [cid, count, f_cpos,
                # f_rpos, f_sbits, l_cpos, l_rpos, l_sbits] once per
                # batch; per-read raws are row views. slots == RUN_LANES,
                # so n_mins > slots routes run-lane overflow rows to the
                # exact host path.
                runs_mat = None
                if total:
                    if pack:
                        cnt_all = planes[0][:total]
                        cid_all, f_cpos = self.didx.decode_gpos(
                            planes[1][:total]
                        )
                        _, l_cpos = self.didx.decode_gpos(planes[2][:total])
                        f_rw, l_rw = planes[3][:total], planes[4][:total]
                    else:
                        cid_all, cnt_all = planes[0][:total], planes[1][:total]
                        f_cpos, l_cpos = planes[2][:total], planes[3][:total]
                        f_rw, l_rw = planes[4][:total], planes[5][:total]
                    runs_mat = np.empty((total, 8), np.int32)
                    runs_mat[:, 0] = cid_all
                    runs_mat[:, 1] = cnt_all
                    runs_mat[:, 2] = f_cpos
                    runs_mat[:, 3] = f_rw & 0x1FFFFFFF
                    runs_mat[:, 4] = (f_rw >> 29) & 3
                    runs_mat[:, 5] = l_cpos
                    runs_mat[:, 6] = l_rw & 0x1FFFFFFF
                    runs_mat[:, 7] = (l_rw >> 29) & 3
                for row, i in rows.items():
                    n = int(count[row])
                    if n_mins[row] > slots:  # run-lane overflow: exact host
                        results[i] = self._host_map_raw(row_codes[row])
                        continue
                    if n == 0:
                        results[i] = None
                        continue
                    o = int(offs[row])
                    results[i] = (n, runs_mat[o : o + n])
                return
            # anchors payload: planes exclude the meta row (row 0 of flat)
            n_planes = int(out["flat"].shape[0]) - 1
            has_r16 = out.get("r16") is not None
            g0 = 0 if has_r16 else 1  # gpos/cid plane index
            if total:
                if has_r16:  # uint16 rpos+strand stream (pads <= 16384)
                    v = r16.view(np.uint16)
                    rpos_all = (v & 0x3FFF).astype(np.int32)
                    sbits_all = ((v >> 14) & 3).astype(np.int32)
                else:
                    rpos_all = planes[0] & 0x1FFFFFFF
                    sbits_all = (planes[0] >> 29) & 3
                if pack:  # one gpos plane -> (cid, cpos), batch-level
                    cid_all, cpos_all = self.didx.decode_gpos(
                        planes[g0][:total]
                    )
                else:
                    cid_all, cpos_all = planes[g0], planes[g0 + 1]
            hash_base = (1 if pack else 2) + (0 if has_r16 else 1)
            for row, i in rows.items():
                n = int(count[row])
                if n_mins[row] > slots:  # slot overflow: redo exactly on host
                    results[i] = self._host_map_raw(row_codes[row])
                    continue
                if n == 0:
                    results[i] = None
                    continue
                o = int(offs[row])
                if n_planes == hash_base + 2:
                    hi = planes[hash_base][o : o + n]
                    lo = planes[hash_base + 1][o : o + n]
                else:
                    hi = lo = np.zeros(n, np.int32)
                results[i] = (
                    n,
                    rpos_all[o : o + n],
                    cid_all[o : o + n],
                    cpos_all[o : o + n],
                    sbits_all[o : o + n],
                    hi,
                    lo,
                )

        # queue depth bounds in-flight batches (device memory). Deeper
        # queues start the async D2H copies of later batches earlier,
        # hiding per-transfer latency; 4 keeps device memory modest (4 x
        # batch_bases packed codes). Not yet tuned on the H100.
        depth = int(os.environ.get("NTLINK_PIPE_DEPTH", "4"))
        pipe = DevicePipeline(
            dispatch_batch, drain, depth=depth, name="ntlink-map"
        )

        def ready_results():
            # deliver strictly in input order, as soon as a read's batch has
            # drained: the consumer's chaining/tally work then overlaps the
            # wire + device time of later batches instead of serializing
            # after the final drain. The drainer thread only ever ADDS keys
            # to `results` (dict ops are GIL-atomic), the main thread pops.
            i = next_yield[0]
            while i < len(pending) and i in results:
                name, length = pending[i]
                pending[i] = None  # free; slot is never revisited
                yield name, length, results.pop(i)
                i += 1
            next_yield[0] = i

        def flush_all():
            for key, idxs in list(buckets.items()):
                if idxs:
                    flush_bucket(key, idxs)
            buckets.clear()
            pipe.join_all()
            for i in range(next_yield[0], len(pending)):
                name, length = pending[i]
                yield name, length, results.pop(i)
            pending.clear()
            results.clear()
            next_yield[0] = 0

        if timing_on:
            def _timed_pull(it):
                it = iter(it)
                while True:
                    t0 = time_mod.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    _t("reader_pull", t0)
                    yield item

            named_seqs = _timed_pull(named_seqs)

        try:
            budget = 0
            for name, payload in named_seqs:
                i = len(pending)
                pending.append((name, len(payload)))
                codes = (
                    payload
                    if isinstance(payload, np.ndarray)
                    else nthash_np.encode(payload)
                )
                seq = payload
                # every mapping step variant (single device, data mesh,
                # hash-sharded index) has nmask plumbing, so N-containing
                # reads always batch on-device; only sub-k/oversized rows
                # take the exact host path
                has_n = bool((codes > 3).any())
                if len(seq) < self.k or len(seq) > self.MAX_PAD:
                    results[i] = self._host_map_raw(codes)
                    yield from ready_results()
                    continue
                encoded[i] = codes
                pad = self._pad_len(len(seq))
                key = (pad, has_n)
                bucket = buckets.setdefault(key, [])
                bucket.append(i)
                cap = max(
                    self.n_devices, _next_pow2(max(1, self.batch_bases // pad))
                )
                if len(bucket) >= cap:
                    flush_bucket(key, bucket)
                    buckets[key] = []
                    yield from ready_results()
                budget += pad
                if budget >= 4 * self.batch_bases:
                    yield from flush_all()
                    budget = 0
            yield from flush_all()
        finally:
            pipe.close()
            if self.host_fallbacks:
                import sys

                print(
                    f"# ntlink device-map: {self.host_fallbacks} read(s) "
                    f"took the exact host fallback path (sub-k, "
                    f"> {self.MAX_PAD} bases, or anchor-slot overflow)",
                    file=sys.stderr,
                )
            if timing_on and tacc:
                import sys

                print(
                    "# ntlink timing: "
                    + " ".join(
                        f"{k}={tacc[k]:.3f}s/{tN[k]}"
                        for k in sorted(tacc)
                    ),
                    file=sys.stderr,
                )
