"""Device mesh + sharded mapping step.

The engine's scaling axis is data parallelism over reads: read batches are
sharded on a 1-D ``data`` mesh axis, the contig minimizer index is replicated
on every device, and per-shard anchor evidence is merged with XLA collectives
(`psum`). This mirrors the problem's structure (index small and read-only,
reads embarrassingly parallel) rather than the reference's process-level
parallelism (reference SURVEY §2c).

Join design: random gathers from a large table are the join's cost, so the
anchor join is (1) deferred until after on-device minimizer compaction (only
~2L/w selected k-mers per read are looked up, not every window) and (2) done
with an open-addressing hash table probed a small constant number of times,
instead of a log2(n)-step binary search.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.sketch_jax import finish_hash, sketch_batch_kernel

_FIB = 0x9E3779B1  # 32-bit Fibonacci hashing constant


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    # local (addressable) devices only: under multi-process runs each host
    # maps its own read-file shard on its own chips (host parallelism is
    # by file sharding, distributed.py), so the mapping mesh never spans
    # non-addressable devices.
    devices = jax.local_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("data",))


#: entries per bucket: one bucket = one contiguous 128 B row, so a query
#: resolves with ONE gather transaction instead of `max_probes` scattered
#: 16 B row gathers. The bucket width and the fills below were chosen on
#: the previous accelerator and are not yet measured on the H100.
BUCKET = 8
#: buckets >= entries / BUCKET_LOAD entries-per-bucket average (pow2
#: count). 4 of 8 slots average keeps overflow chains ~nonexistent while
#: HALVING table bytes vs the old load-0.25 linear-probe layout
#: (~2.1 GB at human scale's 59 M minimizers vs 4.3 GB)
BUCKET_LOAD = 4
#: below this entry count, halve the average fill (2 of 8): overflow
#: chains all but vanish, max_probes is typically 1 and the join's
#: gather volume halves, for table bytes that stay trivial (<= 1 GB)
BUCKET_LOAD_SMALL = 2
SMALL_TABLE_ENTRIES = 32_000_000


class DeviceIndex:
    """Replicated contig-minimizer hash table for on-device joins.

    Bucketized open addressing: `nb` (pow2) buckets of BUCKET=8 entries;
    the device copy is ONE (nb, 32) uint32 tensor per bucket laid out
    [hash_hi x8 | hash_lo x8 | cid_strand x8 | pos x8] = 128 contiguous
    bytes, so each query gathers `max_probes` (typically 1-2) whole
    buckets and compares 8 entries per bucket in-register.
    `cid_strand` = (cid + 1) << 1 | strand; 0 marks an empty slot.
    A bucket overflow spills to the next bucket (linear over buckets);
    `max_probes` is the longest bucket chain observed at build time
    (static gather width on device).
    """

    def __init__(self, hashes: np.ndarray, contig_ids: np.ndarray,
                 positions: np.ndarray, strands: np.ndarray):
        n = int(hashes.shape[0])
        self._build_gpos(contig_ids, positions, n)
        load = (
            BUCKET_LOAD_SMALL if n <= SMALL_TABLE_ENTRIES else BUCKET_LOAD
        )
        nb = 2
        while nb * load < n:
            nb <<= 1
        bmask = nb - 1
        hi = (hashes >> np.uint64(32)).astype(np.uint32)
        lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        cs = (
            ((contig_ids.astype(np.int64) + 1) << 1).astype(np.uint32)
            | strands.astype(np.uint32)
        )
        pos_u = positions.astype(np.uint32)

        ent = np.zeros((nb, 4, BUCKET), np.uint32)
        fill = np.zeros(nb, np.int32)
        cur = (
            ((lo ^ hi) * np.uint32(_FIB)).astype(np.uint32)
            & np.uint32(bmask)
        ).astype(np.int64)
        pending = np.arange(n)
        rounds = 0
        # vectorized insertion rounds: group pending entries by target
        # bucket (stable → deterministic layout), rank within group; ranks
        # beyond the bucket's remaining space spill to the next bucket.
        while pending.size:
            rounds += 1
            bs = cur[pending]
            so = np.argsort(bs, kind="stable")
            ps, bss = pending[so], bs[so]
            newgrp = np.empty(ps.size, bool)
            newgrp[0] = True
            newgrp[1:] = bss[1:] != bss[:-1]
            idx = np.arange(ps.size)
            start = np.maximum.accumulate(np.where(newgrp, idx, 0))
            rank = idx - start + fill[bss]
            place = rank < BUCKET
            pb, pr, pi = bss[place], rank[place], ps[place]
            ent[pb, 0, pr] = hi[pi]
            ent[pb, 1, pr] = lo[pi]
            ent[pb, 2, pr] = cs[pi]
            ent[pb, 3, pr] = pos_u[pi]
            np.add.at(fill, pb, 1)
            pending = ps[~place]
            cur[pending] = (cur[pending] + 1) & bmask

        self.size = nb * BUCKET
        self.mask = bmask
        self.max_probes = max(rounds, 1)
        self.t_bkt = jnp.asarray(ent.reshape(nb, 4 * BUCKET))

    def _build_gpos(self, contig_ids, positions, n) -> None:
        self.host_offsets, self.pack_gpos, self.t_off = build_gpos_offsets(
            contig_ids, positions, n
        )

    def decode_gpos(self, gplane: np.ndarray):
        """Invert the on-device packing: int32 plane -> (cid, cpos)."""
        gpos = gplane.view(np.uint32).astype(np.int64)
        idx = np.searchsorted(self.host_offsets, gpos, side="right") - 1
        return (
            idx.astype(np.int32),
            (gpos - self.host_offsets[idx]).astype(np.int32),
        )

    @classmethod
    def from_contig_index(cls, index) -> "DeviceIndex":
        """Build from an array-backed index.ContigIndex."""
        index.finalize()
        return cls(
            index.hashes, index.contig_ids, index.positions, index.strands
        )


def pack_table_rows(t_hi, t_lo, t_cid, t_pos, t_strand) -> np.ndarray:
    """Stack the five build-time table planes into (size, 4) uint32 rows
    [hash_hi, hash_lo, (cid+1)<<1 | strand, pos]; empty slots get row[2]=0."""
    cs = np.where(
        t_cid >= 0,
        ((t_cid.astype(np.int64) + 1) << 1).astype(np.uint32)
        | t_strand.astype(np.uint32),
        np.uint32(0),
    ).astype(np.uint32)
    return np.stack(
        [t_hi, t_lo, cs, t_pos.astype(np.uint32)], axis=1
    )


def build_gpos_offsets(contig_ids: np.ndarray, positions: np.ndarray, n: int):
    """Global-position packing metadata (D2H payload compression).

    Anchors leave the chip as ONE uint32 plane `gpos = off[cid] + cpos`
    instead of two int32 planes (cid, cpos) — a 33% cut of the dominant
    D2H payload. `off` assigns each contig a span covering every indexed
    position (max pos + 1 suffices: anchors only ever carry positions that
    exist in the table). The host inverts with one vectorized searchsorted
    (DeviceIndex.decode_gpos). Packing is disabled (pack=False, 3-plane
    layout) when the total span exceeds uint32 — beyond ~4.3 Gbase of
    indexed contig span.

    Returns (host_offsets int64 (n_contigs+1,), pack: bool, t_off: device
    uint32 (n_contigs,) or None).
    """
    n_ctg = int(contig_ids.max()) + 1 if n else 1
    spans = np.zeros(n_ctg, np.int64)
    if n:
        np.maximum.at(spans, contig_ids, positions.astype(np.int64) + 1)
    offsets = np.zeros(n_ctg + 1, np.int64)
    np.cumsum(spans, out=offsets[1:])
    pack = bool(offsets[-1] <= 0xFFFFFFFF)
    t_off = jnp.asarray(offsets[:-1].astype(np.uint32)) if pack else None
    return offsets, pack, t_off


def hash_table_join(t_rows, q_hi, q_lo, mask: int, max_probes: int):
    """Probe the row-packed open-addressing table for each (hi, lo) query.

    All `max_probes` candidate slots are gathered AT ONCE (one gather of
    contiguous 16 B rows) and reduced, instead of a fori_loop of probe
    rounds: the sequential loop makes every round's gathers data-depend on
    the previous one, and 3 scattered 4 B gathers per probe waste most of
    each HBM transaction.

    Linear-probe semantics are preserved exactly: a hit at probe p counts
    iff slots 0..p are all occupied (probing stops at the first empty
    slot), and the first such hit wins.
    """
    q_shape = q_hi.shape
    slot0 = (((q_lo ^ q_hi) * jnp.uint32(_FIB)) & jnp.uint32(mask)).astype(
        jnp.int32
    )
    probes = jnp.arange(max_probes, dtype=jnp.int32)
    slots = (slot0[..., None] + probes) & mask  # (..., P)
    rows = t_rows[slots]                        # (..., P, 4) one row gather
    occupied = rows[..., 2] != 0
    match = (
        occupied
        & (rows[..., 0] == q_hi[..., None])
        & (rows[..., 1] == q_lo[..., None])
    )
    # valid iff no empty slot at or before this probe (occupied cancels the
    # inclusive cumsum term, so a hit's own slot never disqualifies it)
    before_empty = jnp.cumsum((~occupied).astype(jnp.int32), axis=-1) == 0
    hit = match & before_empty
    found = hit.any(axis=-1)
    first = jnp.argmax(hit, axis=-1)[..., None]
    cs = jnp.take_along_axis(rows[..., 2], first, axis=-1).reshape(q_shape)
    pos = jnp.take_along_axis(rows[..., 3], first, axis=-1).reshape(q_shape)
    cid = (cs >> 1).astype(jnp.int32) - 1  # -1 when not found (cs == 0)
    return found, cid, pos.astype(jnp.int32), (cs & 1).astype(jnp.bool_)


def hash_bucket_join(t_bkt, q_hi, q_lo, bmask: int, max_bkts: int):
    """Probe the bucketized table (DeviceIndex layout) for each (hi, lo)
    query: gather `max_bkts` whole 128 B buckets per query (ONE gather
    descriptor each) and compare the 8 packed entries per bucket
    in-register. Table
    keys are unique (the contig index dedups), so at most one entry
    matches and argmax-first is exact."""
    qs = q_hi.shape
    b0 = (((q_lo ^ q_hi) * jnp.uint32(_FIB)) & jnp.uint32(bmask)).astype(
        jnp.int32
    )
    bs = (b0[..., None] + jnp.arange(max_bkts, dtype=jnp.int32)) & bmask
    rows = t_bkt[bs]                            # (..., M, 32) bucket gather
    eh = rows[..., 0:BUCKET]
    el = rows[..., BUCKET:2 * BUCKET]
    ecs = rows[..., 2 * BUCKET:3 * BUCKET]
    ep = rows[..., 3 * BUCKET:4 * BUCKET]
    m = (
        (ecs != 0)
        & (eh == q_hi[..., None, None])
        & (el == q_lo[..., None, None])
    )
    m2 = m.reshape(*qs, max_bkts * BUCKET)
    found = m2.any(axis=-1)
    first = jnp.argmax(m2, axis=-1)[..., None]
    cs = jnp.take_along_axis(
        ecs.reshape(*qs, max_bkts * BUCKET), first, axis=-1
    ).reshape(qs)
    pos = jnp.take_along_axis(
        ep.reshape(*qs, max_bkts * BUCKET), first, axis=-1
    ).reshape(qs)
    cid = (cs >> 1).astype(jnp.int32) - 1  # -1 when not found (cs == 0)
    return found, cid, pos.astype(jnp.int32), (cs & 1).astype(jnp.bool_)


#: two-stage minimizer selection: windows split into SELECT_BLOCK-wide
#: column blocks, each block keeps its top SELECT_CAP emitted windows
#: (stage 1), then one top_k over the survivors (stage 2), instead of one
#: flat top_k over all windows (chosen on the previous accelerator; not
#: yet measured on the H100). A block with more than SELECT_CAP emits would lose
#: minimizers, so such rows are flagged and the caller re-runs them on the
#: exact host path — ~2.5 emits per 128 windows expected at w=100, so an
#: overflow needs adversarial (non-genomic) input, but exactness is kept
#: regardless.
SELECT_BLOCK = 128
SELECT_CAP = 16


def select_minimizers(emit, max_slots: int):
    """Order-preserving compaction of emitted window indices to
    `max_slots` per row. Returns (sel, sel_ok, overflow_rows); rows
    flagged in overflow_rows saw a block exceed SELECT_CAP and MUST be
    recomputed exactly by the caller (their sel is incomplete)."""
    B, NW = emit.shape
    NP_ = -(-NW // SELECT_BLOCK) * SELECT_BLOCK
    survivors = (NP_ // SELECT_BLOCK) * SELECT_CAP
    if max_slots > 4096 or NW < 2 * SELECT_BLOCK or survivors < max_slots:
        # huge slot budgets (contig-scale sketch pads) or rows too short
        # for two stages: the flat stable argsort is the better form there
        sel = jnp.argsort(~emit, axis=1, stable=True)[:, :max_slots]
        sel_ok = jnp.take_along_axis(emit, sel, axis=1)
        return sel, sel_ok, jnp.zeros((B,), jnp.bool_)
    # value NP_-i encodes the window index (descending value = ascending
    # window = read order); 0 = not emitted / padding
    idxv = (NP_ - jnp.arange(NW, dtype=jnp.int32))[None, :]
    vals = jnp.zeros((B, NP_), jnp.int32).at[:, :NW].set(
        jnp.where(emit, idxv, 0)
    )
    blk = vals.reshape(B, NP_ // SELECT_BLOCK, SELECT_BLOCK)
    v1, _ = jax.lax.top_k(blk, SELECT_CAP)
    overflow = ((blk > 0).sum(axis=2) > SELECT_CAP).any(axis=1)
    v2, _ = jax.lax.top_k(v1.reshape(B, -1), max_slots)
    sel_ok = v2 > 0
    sel = jnp.where(sel_ok, NP_ - v2, 0)
    return sel, sel_ok, overflow


def compact_flat(mask_flat, width: int):
    """Global order-preserving compaction: returns takef(plane) packing
    plane[mask] to the front of a `width`-lane zero tensor (cumsum +
    scatter — linear, vs the n log n global argsort it replaces)."""
    pos = jnp.cumsum(mask_flat.astype(jnp.int32)) - 1
    tgt = jnp.where(mask_flat, pos, width)

    def takef(a):
        return jnp.zeros(width, a.dtype).at[tgt].set(
            a.reshape(-1), mode="drop"
        )

    return takef


def unpack_codes(packed: jnp.ndarray, L: int) -> jnp.ndarray:
    """(B, L//4) 2-bit-packed uint8 -> (B, L) base codes 0..3.

    The optimization_barrier is a fusion fence: letting XLA fuse the
    bit-expand with the minor-dim reshape sent compile time from under a
    second to minutes at contig-scale L on the previous accelerator."""
    B = packed.shape[0]
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    expanded = (packed[:, :, None] >> shifts[None, None, :]) & 3
    expanded = jax.lax.optimization_barrier(expanded)
    return expanded.reshape(B, L)


def unpack_bits(packed: jnp.ndarray, L: int) -> jnp.ndarray:
    """(B, L//8) bit-packed uint8 (little bit order, np.packbits
    bitorder='little') -> (B, L) bool. Same fusion fence as unpack_codes."""
    B = packed.shape[0]
    shifts = jnp.arange(8, dtype=jnp.uint8)
    expanded = (packed[:, :, None] >> shifts[None, None, :]) & 1
    expanded = jax.lax.optimization_barrier(expanded)
    return expanded.reshape(B, L).astype(jnp.bool_)


#: run lanes for the on-device chaining stage; a read forming more runs
#: (adversarial repeat structure) is routed to the exact host path via
#: the slot-overflow sentinel. Genomic reads form a handful of runs.
RUN_LANES = 64
#: contig-count gate for on-device chaining: the noisy-span aggregates
#: scatter into per-(read, contig) tables of this width. Covers the
#: human-scale use case (~10^2-10^3 scaffolds); larger draft inputs chain
#:  on the host exactly as before.
CHAIN_MAX_CONTIGS = 4096


#: contig-count threshold for the one-hot noisy-span form: builds a
#: (B, NC, S) masked-reduction intermediate instead of 3 scatters into
#: per-(read, contig) tables. The threshold was chosen on the previous
#: accelerator, where scatters serialize, and is not yet measured on the
#: H100. 128 bounds the intermediate to ~256 MB at the largest batch
#: shapes.
NOISY_ONEHOT_MAX = 128


def _mask_lanes(mask, n: int):
    """Lane indices of the first `n` set bits per row, in order, via
    top_k (no scatter): returns (lanes (B, n) int32 clipped for gather
    safety, valid (B, n) bool). Encoding S - lane makes top_k's
    descending values ascend in lane order."""
    B, S = mask.shape
    lane = jnp.arange(S, dtype=jnp.int32)[None, :]
    vals = jnp.where(mask, S - lane, 0)
    v, _ = jax.lax.top_k(vals, min(n, S))
    if S < n:  # short rows: pad to the requested lane count
        v = jnp.concatenate(
            [v, jnp.zeros((B, n - S), jnp.int32)], axis=1
        )
    valid = v > 0
    return jnp.where(valid, S - v, 0), valid


def chain_anchors_device(found, cid, cpos, rlens, clen, z, k: int):
    """On-device replica of the chaining ACCEPTANCE stages — z filter,
    noisy-span filter, consecutive-run grouping, specific-mode subsume
    marking, subsumed-run removal (reference ntlink_utils.py:200-294;
    exact semantics of native/chain.c chain_core) — over the (B, S)
    anchor planes, as masked segmented ops (no data-dependent shapes).

    Valid only for the default knobs (x == 0, sensitive=False, no repeat
    filter) and n_contigs <= CHAIN_MAX_CONTIGS; callers gate and fall
    back to host chaining otherwise. Returns (keep, overflow): `keep`
    marks anchors of accepted runs — their in-row order plus
    consecutive-cid grouping on the host reproduces the final merged
    runs (chain.c prechained mode) — and `overflow` flags rows with more
    than RUN_LANES runs, which must be re-chained exactly on the host.
    """
    B, S = found.shape
    NC = int(clen.shape[0])
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    lane = jnp.arange(S, dtype=jnp.int32)[None, :]

    # 1. z filter (contig length >= z; cid is in range wherever found)
    cidc = jnp.clip(cid, 0, NC - 1)
    kept0 = found & (clen[cidc] >= z)

    # 2. noisy-span filter: per (read, contig) min/max contig position and
    # anchor count; a contig with >= 2 anchors whose contig span outruns
    # read_len + k drops entirely (x == 0 branch of chain.c). Small
    # contig counts use one-hot masked reductions, which fuse;
    # larger ones scatter into (B, NC+1) tables (last col = dump).
    if NC <= NOISY_ONEHOT_MAX:
        m = kept0[:, None, :] & (
            cidc[:, None, :] == jnp.arange(NC, dtype=jnp.int32)[None, :, None]
        )
        amin = jnp.min(
            jnp.where(m, cpos[:, None, :], jnp.int32(0x7FFFFFFF)), axis=2
        )
        amax = jnp.max(jnp.where(m, cpos[:, None, :], jnp.int32(-1)), axis=2)
        acnt = m.sum(axis=2)
        noisy = (acnt >= 2) & ((amax - amin) > (rlens[:, None] + k))
        kept1 = kept0 & ~jnp.take_along_axis(noisy, cidc, axis=1)
    else:
        tcid = jnp.where(kept0, cidc, NC)
        amin = jnp.full((B, NC + 1), jnp.int32(0x7FFFFFFF)).at[
            rows, tcid
        ].min(cpos, mode="drop")
        amax = jnp.full((B, NC + 1), jnp.int32(-1)).at[rows, tcid].max(
            cpos, mode="drop"
        )
        acnt = jnp.zeros((B, NC + 1), jnp.int32).at[rows, tcid].add(
            1, mode="drop"
        )
        noisy = (acnt >= 2) & ((amax - amin) > (rlens[:, None] + k))
        kept1 = kept0 & ~jnp.take_along_axis(noisy, tcid, axis=1)

    # 3. consecutive runs over kept anchors WITHOUT compaction: propagate
    # the previous kept anchor's cid with a cummax over (lane << 13 | cid)
    # (cid < 2^13 by the CHAIN_MAX_CONTIGS gate); a kept anchor starts a
    # run iff the previous kept anchor's cid differs
    # int32 key is safe: lane < 2^18 (max anchor slots) << 13 stays under
    # 2^31 with cid < 2^13 (CHAIN_MAX_CONTIGS gate)
    pk = jnp.where(kept1, (lane << 13) | cidc, jnp.int32(-1))
    cm = jax.lax.cummax(pk, axis=1)
    prev = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), cm[:, :-1]], axis=1
    )
    prev_cid = jnp.where(prev >= 0, prev & 0x1FFF, -1).astype(jnp.int32)
    runstart = kept1 & (prev_cid != cidc)
    run_id = jnp.cumsum(runstart.astype(jnp.int32), axis=1) - 1
    overflow = run_id[:, -1] + 1 > RUN_LANES
    rid = jnp.where(kept1, jnp.minimum(run_id, RUN_LANES - 1), RUN_LANES)

    # run-level contig ids: gather the boundary anchors' cids at the
    # runstart lanes (top_k extraction, no scatter)
    rs_lanes, rvalid = _mask_lanes(runstart, RUN_LANES)
    run_cid = jnp.where(
        rvalid, jnp.take_along_axis(cidc, rs_lanes, axis=1), -1
    )

    # 4. specific-mode subsume. Reference semantics: every contig sighted
    # strictly between the FIRST occurrence of a contig c and any later
    # occurrence of c is doomed (all of its runs drop). The union of
    # those open intervals over c's later occurrences is (first[c],
    # last[c]), so between[q] = exists i < q with is_first[i] and
    # last_occ[i] > q — one exclusive prefix-max. RUN_LANES is small, so
    # first/last occurrence come from O(R^2) masked reductions.
    r = jnp.arange(RUN_LANES, dtype=jnp.int32)
    same = (
        rvalid[:, :, None]
        & rvalid[:, None, :]
        & (run_cid[:, :, None] == run_cid[:, None, :])
    )
    has_earlier = (same & (r[None, :, None] > r[None, None, :])).any(axis=2)
    is_first = rvalid & ~has_earlier
    last_occ = jnp.max(
        jnp.where(same, r[None, None, :], -1), axis=2
    )
    f = jnp.where(is_first, last_occ, -1)
    pmax = jax.lax.cummax(f, axis=1)
    pmax_excl = jnp.concatenate(
        [jnp.full((B, 1), -1, f.dtype), pmax[:, :-1]], axis=1
    )
    between = rvalid & (pmax_excl > r[None, :])
    doomed = (same & between[:, None, :]).any(axis=2)
    keep_run = rvalid & ~doomed

    # 5. an anchor survives iff its run does; overflow rows are wiped so
    # their (host-recomputed) offsets stay consistent
    keep = kept1 & jnp.take_along_axis(
        jnp.concatenate(
            [keep_run, jnp.zeros((B, 1), jnp.bool_)], axis=1
        ),
        rid,
        axis=1,
    )
    return keep & ~overflow[:, None], overflow


def summarize_runs_device(keep, cid, cpos, rposw):
    """Per-read run summaries from accepted anchors — the exact semantics
    of chain.c's prechained grouping (consecutive kept anchors with the
    same cid form one merged run) plus the per-run fields the pair tally
    consumes (pairs.PairTally._add reads only contig / hit_count /
    first_hit / terminal_hit; reference ntlink_pair.py:416-435).

    Returns (valid (B, RUN_LANES) bool in read order, run_cid, count,
    f_cpos, l_cpos, f_rposw, l_rposw — all (B, RUN_LANES) int32). The
    caller guarantees rows with more than RUN_LANES pre-merge runs were
    already wiped from `keep` (chain_anchors_device overflow), so run
    indices never clip.
    """
    B, S = keep.shape
    lane = jnp.arange(S, dtype=jnp.int32)[None, :]
    ccid = jnp.maximum(cid, 0)

    # previous / next kept anchor's cid (same cummax trick as
    # chain_anchors_device step 3; the reversed key ranks SMALLER lanes
    # higher so the suffix cummax finds the nearest following kept anchor)
    pk = jnp.where(keep, (lane << 13) | ccid, jnp.int32(-1))
    cm = jax.lax.cummax(pk, axis=1)
    prev = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), cm[:, :-1]], axis=1
    )
    prev_cid = jnp.where(prev >= 0, prev & 0x1FFF, -1)
    runstart = keep & (prev_cid != ccid)
    pk2 = jnp.where(keep, ((S - 1 - lane) << 13) | ccid, jnp.int32(-1))
    cmr = jax.lax.cummax(jnp.flip(pk2, axis=1), axis=1)
    nxt = jnp.flip(
        jnp.concatenate(
            [jnp.full((B, 1), -1, jnp.int32), cmr[:, :-1]], axis=1
        ),
        axis=1,
    )
    next_cid = jnp.where(nxt >= 0, nxt & 0x1FFF, -1)
    runend = keep & (next_cid != ccid)

    # scatter-free field extraction: top_k finds the runstart/runend
    # lanes per row in run order (chosen over 6 run-lane scatters on the
    # previous accelerator; not yet measured on the H100), then every
    # per-run field is one gather.
    # Anchor counts come from gathered inclusive-kept-prefix sums at the
    # run's boundary anchors (end - start + 1).
    rs_lanes, rvalid = _mask_lanes(runstart, RUN_LANES)
    re_lanes, _ = _mask_lanes(runend, RUN_LANES)
    kc = jnp.cumsum(keep.astype(jnp.int32), axis=1)

    def g(a, lanes):
        return jnp.take_along_axis(a, lanes, axis=1)

    count = jnp.where(
        rvalid, g(kc, re_lanes) - g(kc, rs_lanes) + 1, 0
    )
    return (
        rvalid,
        g(ccid, rs_lanes),
        count,
        g(cpos, rs_lanes),
        g(cpos, re_lanes),
        g(rposw, rs_lanes),
        g(rposw, re_lanes),
    )


def sketch_rows(codes, lengths, k: int, w: int, nmask=None):
    """Sketch a (B, L) batch of base codes: the one sketch form every step
    shares. `nmask` ((B, L//8) bit-packed uint8) marks non-ACGT bases;
    such batches take the compacted-window kernel (reference N semantics:
    windows of w consecutive *valid* k-mers spanning gaps).

    The outputs pass an optimization_barrier, a fusion fence: without it
    XLA's fusion search across the unrolled hash graph and the gather/sort
    consumers took minutes of compile time at contig-scale L on the
    previous accelerator (pads reach 2^21)."""
    with jax.named_scope("sketch"):
        if nmask is not None:
            # sentinel 4 re-materializes the non-ACGT positions the 2-bit
            # packing cannot carry; the kernel invalidates k-mers covering
            # them
            codes = jnp.where(
                unpack_bits(nmask, codes.shape[1]), jnp.uint8(4), codes
            )
        out = sketch_batch_kernel(
            codes, lengths, k, w, compact_invalid=nmask is not None
        )
    return jax.lax.optimization_barrier(out)


def mapping_step_packed(packed, lengths, t_bkt,
                        k: int, w: int, L: int, mask: int, max_probes: int,
                        max_anchors: int,
                        with_hashes: bool = True, nmask=None, t_off=None,
                        chain_clen=None, chain_z=None, emit_runs: bool = False):
    """Fused mapping step: unpack -> sketch -> compact minimizers ->
    bucket hash-join -> [optional on-device chaining] -> global anchor
    compaction. Outputs are O(anchors), not
    O(bases): `meta` = per-read [counts | n_minimizers] (2B,) and `flat` =
    (planes, B*S) with all matched anchors packed front in read order —
    plane 0 read positions (strand bits in bits 29/30), then EITHER one
    packed global-position plane `off[cid] + cpos` (when `t_off`, the
    per-contig uint32 offset table, is given — DeviceIndex.pack_gpos) OR
    two planes (contig ids, contig positions); hash-half planes follow only
    when `with_hashes` (repeat filter). `nmask` ((B, L//8) bit-packed
    uint8) batches N-containing reads through the compacted-window kernel
    (reference N semantics) instead of the per-read host fallback.

    When `chain_clen` ((n_contigs,) int32 device lengths) and `chain_z`
    (scalar) are given, the chaining acceptance stages run ON DEVICE
    (chain_anchors_device) and only accepted-run anchors ship; rows whose
    run count overflows RUN_LANES report n_minimizers > max_anchors so
    the drain re-chains them exactly on the host (SURVEY §7 layer 4).
    """
    can_hi, can_lo, fwd, winner, emit = sketch_rows(
        unpack_codes(packed, L), lengths, k, w, nmask
    )

    # compact selected minimizers (order-preserving): ~2L/w of L-k+1 windows
    B, NW = emit.shape
    sel, sel_ok, sel_overflow = select_minimizers(emit, max_anchors)
    m_pos = jnp.take_along_axis(winner, sel, axis=1)
    q_hi = jnp.take_along_axis(can_hi, jnp.maximum(m_pos, 0), axis=1)
    q_lo = jnp.take_along_axis(can_lo, jnp.maximum(m_pos, 0), axis=1)
    # reported hash on the compacted set only (the kernels return canonical)
    q_hi, q_lo = finish_hash(q_hi, q_lo, k)
    m_fwd = jnp.take_along_axis(fwd, jnp.maximum(m_pos, 0), axis=1)

    found, cid, cpos, cstrand = hash_bucket_join(
        t_bkt, q_hi, q_lo, mask, max_probes
    )
    found = found & sel_ok
    overflow_rows = sel_overflow
    if chain_clen is not None:
        found, chain_overflow = chain_anchors_device(
            found, cid, cpos, lengths, chain_clen, chain_z, k
        )
        overflow_rows = overflow_rows | chain_overflow

    if emit_runs:
        # O(runs) payload (non-verbose/non-PAF runs): the pair tally reads
        # only each merged run's cid / anchor count / first / terminal
        # anchor, so only those ship — ~32 B per RUN instead of ~10 B per
        # ANCHOR x ~dozens of anchors per read, a ~10x cut of the dominant
        # D2H direction. Requires the on-device chaining stage (callers
        # gate on prechained).
        assert chain_clen is not None and not with_hashes
        rposw = (
            m_pos
            | (cstrand.astype(jnp.int32) << 29)
            | (m_fwd.astype(jnp.int32) << 30)
        )
        rvalid, r_cid, r_cnt, f_cpos, l_cpos, f_rposw, l_rposw = (
            summarize_runs_device(found, cid, cpos, rposw)
        )
        B_ = rvalid.shape[0]
        takef = compact_flat(rvalid.reshape(-1), B_ * RUN_LANES)
        if t_off is not None:
            gp = lambda cp: jax.lax.bitcast_convert_type(
                t_off[r_cid] + cp.astype(jnp.uint32), jnp.int32
            )
            planes = [r_cnt, gp(f_cpos), gp(l_cpos), f_rposw, l_rposw]
        else:
            planes = [r_cid, r_cnt, f_cpos, l_cpos, f_rposw, l_rposw]
        # overflow rows report past the run-lane budget in the meta's
        # n_minimizers half: the drain's slot-overflow branch (slots =
        # flat width / B = RUN_LANES here) re-maps them exactly on host.
        # The meta rides as ROW 0 of the flat tensor (2B <= B*RUN_LANES):
        # the whole batch then drains with ONE D2H object
        meta = jnp.concatenate([
            rvalid.sum(axis=1).astype(jnp.int32),
            jnp.where(overflow_rows, RUN_LANES + 1, 0).astype(jnp.int32),
        ])
        meta_row = jnp.zeros((B_ * RUN_LANES,), jnp.int32).at[
            : 2 * B_
        ].set(meta)
        return {
            "flat": jnp.stack([meta_row] + [takef(p) for p in planes],
                              axis=0),
            "n_anchors": found.sum(),
        }

    # selection/chain-overflow rows report n_minimizers past the slot
    # budget: the drain's existing slot-overflow branch re-maps them
    # exactly on the host (adversarial inputs only in practice)
    n_minimizers = jnp.where(
        overflow_rows,
        jnp.maximum(emit.sum(axis=1), max_anchors + 1),
        emit.sum(axis=1),
    ).astype(jnp.int32)
    count = found.sum(axis=1).astype(jnp.int32)

    # Global (whole-batch) anchor compaction: every matched anchor, in
    # row-major read order, packed to the front of ONE flat tensor. The
    # host slices it to the exact total anchor count, so the D2H transfer
    # is O(total anchors) bytes. Cumsum + scatter preserves both read order and
    # within-read anchor order at linear cost (vs the n log n argsort).
    takef = compact_flat(found.reshape(-1), B * max_anchors)
    # read positions: pads <= 16384 fit rpos in 14 bits, so the whole
    # rpos+strand word ships as a SEPARATE uint16 stream ("r16") — half
    # the bytes of an int32 plane on the dominant D2H direction. Larger
    # pads keep the int32 plane-0 layout (strand bits at 29/30).
    use_r16 = L <= 16384
    planes = []
    out_r16 = None
    if use_r16:
        out_r16 = takef(
            (
                m_pos
                | (cstrand.astype(jnp.int32) << 14)
                | (m_fwd.astype(jnp.int32) << 15)
            ).astype(jnp.uint16)
        )
    else:
        rpos_packed = (
            m_pos
            | (cstrand.astype(jnp.int32) << 29)
            | (m_fwd.astype(jnp.int32) << 30)
        )
        planes.append(takef(rpos_packed))
    if t_off is not None:
        gpos = t_off[jnp.maximum(cid, 0)] + cpos.astype(jnp.uint32)
        gplane = jax.lax.bitcast_convert_type(gpos, jnp.int32)
        planes.append(takef(gplane))
    else:
        planes += [takef(cid), takef(cpos)]
    if with_hashes:
        planes += [takef(q_hi).astype(jnp.int32), takef(q_lo).astype(jnp.int32)]
    # per-row metadata rides as ROW 0 of the flat tensor (2B <= B*S lanes;
    # the transfer cap never cuts below 2B): one fewer D2H object per
    # batch
    meta_row = jnp.zeros((B * max_anchors,), jnp.int32).at[: 2 * B].set(
        jnp.concatenate([count, n_minimizers])
    )
    flat = jnp.stack([meta_row] + planes, axis=0)  # (2..6, B*S) int32
    out = {
        "flat": flat,
        "n_anchors": found.sum(),
    }
    if use_r16:
        out["r16"] = out_r16
    return out


def sketch_step_packed(packed, lengths, k: int, w: int, L: int, max_mins: int,
                       nmask=None):
    """Sketch-only fused step: unpack -> hash -> window-min -> global
    compaction (same output contract as the mapping step: `meta` =
    [counts | n_minimizers] and `flat` = (3, B*S) int32 planes
    [position+strand, hash_hi, hash_lo] packed front in row order).
    Transfers are O(minimizers); powers the indexlr-equivalent contig TSV
    sketching at scale. `nmask` (optional, (B, L//8) bit-packed uint8)
    marks non-ACGT bases for batches of N-containing rows (draft scaffolds
    are full of N gaps — the primary input of rounds >= 2); see
    sketch_packed.
    """
    can_hi, can_lo, fwd, winner, emit = sketch_rows(
        unpack_codes(packed, L), lengths, k, w, nmask
    )
    B = emit.shape[0]
    sel, sel_ok, sel_overflow = select_minimizers(emit, max_mins)
    m_pos = jnp.take_along_axis(winner, sel, axis=1)
    gather = lambda a: jnp.take_along_axis(a, jnp.maximum(m_pos, 0), axis=1)
    out_hi, out_lo = finish_hash(gather(can_hi), gather(can_lo), k)
    # strand rides in bit 30 of the position word (positions < 2^21)
    pos_strand = m_pos | (gather(fwd).astype(jnp.int32) << 30)
    # count MUST equal the entries actually packed into flat (sel_ok can
    # undercount emit on a selection-overflow row — those rows are host-
    # redone, but their count still positions every later row's offset)
    count = sel_ok.sum(axis=1).astype(jnp.int32)
    takef = compact_flat(sel_ok.reshape(-1), B * max_mins)
    flat = jnp.stack(
        [
            takef(pos_strand),
            takef(out_hi.astype(jnp.int32)),
            takef(out_lo.astype(jnp.int32)),
        ],
        axis=0,
    )
    # selection-overflow rows report n_minimizers past the slot budget so
    # the drain's slot-overflow branch re-sketches them exactly on host
    n_min_rep = jnp.where(
        sel_overflow,
        jnp.maximum(emit.sum(axis=1), max_mins + 1),
        emit.sum(axis=1),
    ).astype(jnp.int32)
    return {
        "meta": jnp.concatenate([count, n_min_rep]),
        "flat": flat,
    }


def mapping_step(codes, lengths, idx_hi, idx_lo, idx_cid, idx_pos, idx_strand,
                 k: int, w: int):
    """Compatibility wrapper over unpacked codes with a sorted-array index.

    Used by the graft entry; production path is mapping_step_packed.
    """
    can_hi, can_lo, fwd, winner, emit = sketch_batch_kernel(codes, lengths, k, w)
    w_hi = jnp.take_along_axis(can_hi, winner, axis=1)
    w_lo = jnp.take_along_axis(can_lo, winner, axis=1)
    w_hi, w_lo = finish_hash(w_hi, w_lo, k)
    pos, found = lex_binary_search(idx_hi, idx_lo, w_hi, w_lo, idx_hi.shape[0])
    found = found & emit
    return {
        "found": found,
        "anchor_cid": jnp.where(found, idx_cid[pos], -1),
        "anchor_pos": jnp.where(found, idx_pos[pos], -1),
        "anchor_strand": jnp.where(found, idx_strand[pos], False),
        "winner": winner,
        "n_anchors": found.sum(),
    }


def lex_binary_search(idx_hi, idx_lo, q_hi, q_lo, n: int):
    """Vectorized lower-bound search of (hi, lo) query pairs in a sorted
    (hi, lo) table (kept for the compatibility wrapper + tests)."""
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    lo_b = jnp.zeros(q_hi.shape, jnp.int32)
    hi_b = jnp.full(q_hi.shape, n, jnp.int32)

    def body(_, carry):
        lo_b, hi_b = carry
        mid = (lo_b + hi_b) >> 1
        m_hi = idx_hi[mid]
        m_lo = idx_lo[mid]
        less = (m_hi < q_hi) | ((m_hi == q_hi) & (m_lo < q_lo))
        return jnp.where(less, mid + 1, lo_b), jnp.where(less, hi_b, mid)

    lo_b, hi_b = jax.lax.fori_loop(0, steps, body, (lo_b, hi_b))
    pos = jnp.minimum(lo_b, n - 1)
    found = (idx_hi[pos] == q_hi) & (idx_lo[pos] == q_lo)
    return pos, found


class SortedDeviceIndex:
    """Sorted (hi, lo) arrays — used by the compatibility mapping_step."""

    def __init__(self, hashes, contig_ids, positions, strands):
        order = np.argsort(hashes, kind="stable")
        h = hashes[order]
        self.hi = jnp.asarray((h >> np.uint64(32)).astype(np.uint32))
        self.lo = jnp.asarray((h & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        self.contig_ids = jnp.asarray(contig_ids[order].astype(np.int32))
        self.positions = jnp.asarray(positions[order].astype(np.int32))
        self.strands = jnp.asarray(strands[order])


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """(B, L) base codes (0..3; L % 4 == 0) -> (B, L//4) packed uint8."""
    B, L = codes.shape
    c = codes.reshape(B, L // 4, 4)
    out = c[:, :, 3] << 6
    out |= c[:, :, 2] << 4
    out |= c[:, :, 1] << 2
    out |= c[:, :, 0]
    return out


def make_sharded_mapping_step(mesh: Mesh, k: int, w: int, L: int,
                              mask: int, max_probes: int, max_anchors: int,
                              with_hashes: bool = True,
                              chain_clen=None, chain_z: int = 0,
                              emit_runs: bool = False):
    """jit the packed mapping step with batch rows sharded over the data
    axis and the table replicated; XLA inserts the collectives.
    `chain_clen` ((n_contigs,) int32, replicated like the table) enables
    the on-device chaining stage (chain_anchors_device) — per-row masked
    ops only, so it shards over `data` like the rest of the step.
    `emit_runs` additionally switches the payload to O(runs) summaries
    (summarize_runs_device); requires chain_clen."""
    data_sharding = NamedSharding(mesh, P("data", None))
    repl = NamedSharding(mesh, P())
    do_chain = chain_clen is not None
    assert not (emit_runs and not do_chain)
    clen_op = (
        jnp.asarray(chain_clen) if do_chain else jnp.zeros(1, jnp.int32)
    )

    @functools.partial(
        jax.jit,
        static_argnums=(5, 6, 7, 8, 9, 10, 11, 12, 13, 14),
        in_shardings=(
            data_sharding, NamedSharding(mesh, P("data")), repl, repl, repl,
        ),
    )
    def step(packed, lengths, t_bkt, t_off, clen,
             k_, w_, L_, mask_, probes_, anchors_, with_hashes_, pack_gpos_,
             do_chain_, emit_runs_):
        return mapping_step_packed(
            packed, lengths, t_bkt,
            k_, w_, L_, mask_, probes_, anchors_, with_hashes=with_hashes_,
            t_off=t_off if pack_gpos_ else None,
            chain_clen=clen if do_chain_ else None, chain_z=chain_z,
            emit_runs=emit_runs_,
        )

    @functools.partial(
        jax.jit,
        static_argnums=(6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
        in_shardings=(
            data_sharding, NamedSharding(mesh, P("data")), repl, repl, repl,
            data_sharding,
        ),
    )
    def step_n(packed, lengths, t_bkt, t_off, clen, nmask,
               k_, w_, L_, mask_, probes_, anchors_, with_hashes_,
               pack_gpos_, do_chain_, emit_runs_):
        # N batch: rows shard like the code rows; compacted-window kernel
        return mapping_step_packed(
            packed, lengths, t_bkt,
            k_, w_, L_, mask_, probes_, anchors_, with_hashes=with_hashes_,
            nmask=nmask, t_off=t_off if pack_gpos_ else None,
            chain_clen=clen if do_chain_ else None, chain_z=chain_z,
            emit_runs=emit_runs_,
        )

    def run(packed, lengths, didx, nmask=None):
        t_off = getattr(didx, "t_off", None)
        pack = t_off is not None
        if not pack:  # dummy replicated operand; unused under pack_gpos_=False
            t_off = jnp.zeros(1, jnp.uint32)
        if nmask is None:
            return step(
                packed, lengths, didx.t_bkt, t_off, clen_op, k, w, L, mask,
                max_probes, max_anchors, with_hashes, pack, do_chain,
                emit_runs,
            )
        return step_n(
            packed, lengths, didx.t_bkt, t_off, clen_op, nmask, k, w, L,
            mask, max_probes, max_anchors, with_hashes, pack, do_chain,
            emit_runs,
        )

    return run


def dryrun(n_devices: int, k: int = 32, w: int = 100) -> None:
    """Compile + execute one sharded mapping step on an n-device mesh with a
    tiny synthetic batch; validates the multi-chip path end to end."""
    rng = np.random.default_rng(0)
    B, L = n_devices * 2, 2048
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = np.full(B, L, dtype=np.int32)

    # synthetic replicated index drawn from the batch itself
    from ..ops import nthash_np

    mins = nthash_np.sketch_codes(codes[0], k, w)
    didx = DeviceIndex(
        mins.hashes,
        np.zeros(len(mins), dtype=np.int32),
        mins.positions.astype(np.int32),
        mins.forward,
    )
    mesh = make_mesh(n_devices)
    step = make_sharded_mapping_step(
        mesh, k, w, L, didx.mask, didx.max_probes, 256
    )
    out = step(
        jnp.asarray(pack_codes(codes)), jnp.asarray(lengths), didx
    )
    jax.block_until_ready(out)
    n_anchors = int(out["n_anchors"])
    assert n_anchors >= len(mins), "sharded join lost anchors"

    # N-batch variant: plant an N run in every row; the compacted-window
    # kernel must compile + run under the same shardings and still find
    # the anchors outside the gap
    bad = np.zeros((B, L), dtype=bool)
    bad[:, 700:760] = True
    codes_n = np.where(bad, 0, codes).astype(np.uint8)
    nmask = np.packbits(bad, axis=1, bitorder="little")
    out_n = step(
        jnp.asarray(pack_codes(codes_n)), jnp.asarray(lengths), didx,
        jnp.asarray(nmask),
    )
    jax.block_until_ready(out_n)
    assert int(out_n["n_anchors"]) > 0, "sharded N join found no anchors"

    # on-device chaining variant: same shardings plus the replicated
    # contig-length operand; every anchor maps cleanly to the one long
    # contig, so chaining must accept them all
    step_c = make_sharded_mapping_step(
        mesh, k, w, L, didx.mask, didx.max_probes, 256,
        chain_clen=np.full(1, L, np.int32), chain_z=1,
    )
    out_c = step_c(
        jnp.asarray(pack_codes(codes)), jnp.asarray(lengths), didx
    )
    jax.block_until_ready(out_c)
    assert int(out_c["n_anchors"]) > 0, "chained sharded step lost anchors"

    # runs-only variant (O(runs) payload): meta rides in flat row 0; every
    # row anchors to the single contig, so each filled row reports exactly
    # one run and zero overflow
    step_r = make_sharded_mapping_step(
        mesh, k, w, L, didx.mask, didx.max_probes, 256, with_hashes=False,
        chain_clen=np.full(1, L, np.int32), chain_z=1, emit_runs=True,
    )
    out_r = step_r(
        jnp.asarray(pack_codes(codes)), jnp.asarray(lengths), didx
    )
    jax.block_until_ready(out_r)
    # only row 0 matches the synthetic index (built from row 0's sketch):
    # it must report exactly one merged run; no row may flag overflow
    flat_r = np.asarray(out_r["flat"])
    counts_r, over_r = flat_r[0, :B], flat_r[0, B : 2 * B]
    assert counts_r[0] == 1, counts_r
    assert (over_r == 0).all(), over_r
