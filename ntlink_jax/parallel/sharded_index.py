"""Hash-sharded contig index across a 2-D (data, idx) device mesh.

The default engine replicates the contig hash table per device (~1.7 GB for
a human assembly at w=100 — see DESIGN.md sizing). For indexes that outgrow
one chip's HBM (pangenomes, very small w), this variant shards the table by
a hash bucket over the ``idx`` mesh axis:

- the build partitions entries by the top bits of the Fibonacci slot hash
  (uniform by construction) into `n_shards` independent open-addressing
  sub-tables, inserted with the same vectorized contended-claim rounds as
  the replicated builder (mesh.DeviceIndex) — all shards at once on a flat
  (n_shards * size) table,
- the join runs under shard_map on a 2-D mesh: batch rows shard over
  ``data``, each ``idx`` rank probes its local sub-table with the full query
  set of its data row-block, and per-query results combine with a
  ``psum`` over ``idx`` (each query hits exactly one shard, so the sum is
  the unique answer),
- the surrounding jit applies the engine's standard output contract
  (global anchor compaction into `meta` + `flat`, parallel.mesh), so
  DeviceMapper drains both index layouts identically
  (`DeviceMapper(index_sharding="hash")` / CLI `index_sharding=hash`).

The reduction rides the device interconnect (NVLink between local GPUs);
tests run it on the virtual CPU mesh and assert bit-equality with the
replicated path.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from .mesh import _FIB, build_gpos_offsets, sketch_rows, unpack_codes
from ..ops.sketch_jax import finish_hash


class ShardedDeviceIndex:
    """Per-shard open-addressing sub-tables, stacked (n_shards, size)."""

    def __init__(self, hashes: np.ndarray, contig_ids: np.ndarray,
                 positions: np.ndarray, strands: np.ndarray, n_shards: int):
        assert n_shards & (n_shards - 1) == 0, "n_shards must be a power of 2"
        self.n_shards = n_shards
        n = int(hashes.shape[0])
        self.host_offsets, self.pack_gpos, self.t_off = build_gpos_offsets(
            contig_ids, positions, n
        )
        hi = (hashes >> np.uint64(32)).astype(np.uint32)
        lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        slot_hash = ((lo ^ hi) * np.uint32(_FIB)).astype(np.uint32)
        shard = (
            (slot_hash >> np.uint32(32 - int(np.log2(n_shards)))).astype(np.int64)
            if n_shards > 1
            else np.zeros(n, np.int64)
        )

        counts = np.bincount(shard, minlength=n_shards)
        size = 1
        while size < max(2 * int(counts.max() if counts.size else 1), 16):
            size <<= 1
        self.size = size
        self.mask = size - 1

        flat = n_shards * size
        t_hi = np.zeros(flat, np.uint32)
        t_lo = np.zeros(flat, np.uint32)
        t_cid = np.full(flat, -1, np.int32)
        t_pos = np.zeros(flat, np.int32)
        t_strand = np.zeros(flat, bool)

        # vectorized insertion (mesh.DeviceIndex scheme): every pending
        # entry claims its slot, one winner per slot per round, losers
        # advance one local slot (wrapping within their shard's span)
        local = (slot_hash & np.uint32(self.mask)).astype(np.int64)
        base = shard * size
        pending = np.arange(n)
        claim = np.full(flat, -1, np.int64)
        rounds = 0
        while pending.size:
            rounds += 1
            want = base[pending] + local[pending]
            free = t_cid[want] == -1
            claim[want[free]] = pending[free]  # last writer wins; rest retry
            won = claim[want] == pending
            winners = pending[won]
            w_slots = base[winners] + local[winners]
            t_hi[w_slots] = hi[winners]
            t_lo[w_slots] = lo[winners]
            t_cid[w_slots] = contig_ids[winners]
            t_pos[w_slots] = positions[winners]
            t_strand[w_slots] = strands[winners]
            pending = pending[~won]
            local[pending] = (local[pending] + 1) & self.mask
        self.max_probes = (max(rounds, 1) + 3) & ~3
        from .mesh import pack_table_rows

        # row-packed like the replicated table (mesh.DeviceIndex): one
        # contiguous 16 B gather per probe
        self.t_rows = pack_table_rows(
            t_hi, t_lo, t_cid, t_pos, t_strand
        ).reshape(n_shards, size, 4)

    def decode_gpos(self, gplane: np.ndarray):
        """Invert the on-device gpos packing: int32 plane -> (cid, cpos)."""
        gpos = gplane.view(np.uint32).astype(np.int64)
        idx = np.searchsorted(self.host_offsets, gpos, side="right") - 1
        return (
            idx.astype(np.int32),
            (gpos - self.host_offsets[idx]).astype(np.int32),
        )

    @classmethod
    def from_contig_index(cls, index, n_shards: int) -> "ShardedDeviceIndex":
        index.finalize()
        return cls(
            index.hashes, index.contig_ids, index.positions, index.strands,
            n_shards,
        )


def make_mesh_2d(idx_shards: int, n_devices: int = None) -> Mesh:
    """2-D (data, idx) mesh over the local devices."""
    devices = jax.local_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    assert n % idx_shards == 0, (n, idx_shards)
    return Mesh(
        np.array(devices).reshape(n // idx_shards, idx_shards),
        ("data", "idx"),
    )


def _sharded_join(mesh: Mesh, sidx: ShardedDeviceIndex, k: int, w: int,
                  max_anchors: int, with_nmask: bool = False):
    """shard_map'd sketch + local-probe + psum join over the 2-D mesh.

    Returns fn(codes, lengths, *tables[, nmask]) -> per-row (count,
    n_minimizers, rpos_packed, cid, cpos, found), each (B, S) with strand
    bits packed in rpos_packed bits 29/30 (the engine's standard anchor
    word).

    `with_nmask=True` builds the N-batch variant: a (B, L//8) bit-packed
    non-ACGT mask shards like the code rows and the sketch takes the
    compacted-window kernel (reference N semantics).
    """
    n_shards = sidx.n_shards
    mask = sidx.mask
    max_probes = sidx.max_probes
    shard_shift = 32 - int(np.log2(n_shards)) if n_shards > 1 else 32

    def local_probe(t_rows, q_hi, q_lo):
        """Probe this rank's sub-table; miss -> found False.

        Same one-shot row-gather probing as mesh.hash_table_join (all
        max_probes 16 B rows gathered at once — the fori_loop form
        serializes the gathers), gated by shard ownership."""
        q_shape = q_hi.shape
        slot_hash = (q_lo ^ q_hi) * jnp.uint32(_FIB)
        my_shard = jax.lax.axis_index("idx").astype(jnp.uint32)
        want_shard = (
            (slot_hash >> jnp.uint32(shard_shift))
            if n_shards > 1
            else jnp.zeros_like(slot_hash)
        )
        mine = want_shard == my_shard
        slot0 = (slot_hash & jnp.uint32(mask)).astype(jnp.int32)
        probes = jnp.arange(max_probes, dtype=jnp.int32)
        slots = (slot0[..., None] + probes) & mask
        rows = t_rows[slots]
        occupied = rows[..., 2] != 0
        match = (
            occupied
            & (rows[..., 0] == q_hi[..., None])
            & (rows[..., 1] == q_lo[..., None])
        )
        before_empty = jnp.cumsum((~occupied).astype(jnp.int32), axis=-1) == 0
        hit = match & before_empty & mine[..., None]
        found = hit.any(axis=-1)
        first = jnp.argmax(hit, axis=-1)[..., None]
        cs = jnp.take_along_axis(rows[..., 2], first, axis=-1).reshape(q_shape)
        pos = jnp.take_along_axis(rows[..., 3], first, axis=-1).reshape(q_shape)
        cs = jnp.where(found, cs, 0)
        pos = jnp.where(found, pos, 0)
        cid = jnp.maximum((cs >> 1).astype(jnp.int32) - 1, 0)
        return found, cid, pos.astype(jnp.int32), (cs & 1).astype(jnp.bool_)

    def step(codes, lengths, t_rows, *nm):
        # per-rank table block has a leading shard dim of 1
        t_rows = t_rows[0]
        can_hi, can_lo, fwd, winner, emit = sketch_rows(
            codes, lengths, k, w, nm[0] if with_nmask else None
        )
        sel = jnp.argsort(~emit, axis=1, stable=True)[:, :max_anchors]
        sel_ok = jnp.take_along_axis(emit, sel, axis=1)
        m_pos = jnp.take_along_axis(winner, sel, axis=1)
        q_hi = jnp.take_along_axis(can_hi, jnp.maximum(m_pos, 0), axis=1)
        q_lo = jnp.take_along_axis(can_lo, jnp.maximum(m_pos, 0), axis=1)
        q_hi, q_lo = finish_hash(q_hi, q_lo, k)
        m_fwd = jnp.take_along_axis(fwd, jnp.maximum(m_pos, 0), axis=1)

        found, cid, cpos, cstrand = local_probe(t_rows, q_hi, q_lo)
        # each query lives in exactly one shard: psum yields the unique hit
        found = found & sel_ok
        found_any = jax.lax.psum(found.astype(jnp.int32), "idx") > 0
        cid_g = jax.lax.psum(jnp.where(found, cid, 0), "idx")
        cpos_g = jax.lax.psum(jnp.where(found, cpos, 0), "idx")
        cstr_g = jax.lax.psum(
            jnp.where(found, cstrand.astype(jnp.int32), 0), "idx"
        )
        rpos_packed = m_pos | (cstr_g << 29) | (m_fwd.astype(jnp.int32) << 30)
        count = found_any.sum(axis=1).astype(jnp.int32)
        n_minimizers = emit.sum(axis=1).astype(jnp.int32)
        # q_hi/q_lo come from the sketch of this rank's data block alone —
        # identical on every idx rank, so they are replicated over idx by
        # construction (no collective needed). Returned for the repeat
        # filter's matched-hash readback (pipeline._map_reads_generic).
        return (count, n_minimizers, rpos_packed, cid_g, cpos_g, found_any,
                q_hi, q_lo)

    data_spec = P("data", None)
    table_spec = P("idx", None, None)
    in_specs = (data_spec, P("data"), table_spec)
    if with_nmask:
        in_specs = in_specs + (data_spec,)
    return shard_map(
        step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(
            P("data"), P("data"), data_spec, data_spec, data_spec, data_spec,
            data_spec, data_spec,
        ),
        check_vma=False,
    )


def make_sharded_index_mapping_step(mesh: Mesh, sidx: ShardedDeviceIndex,
                                    k: int, w: int, L: int,
                                    max_anchors: int,
                                    with_hashes: bool = False):
    """Full mapping step over the hash-sharded index — packed input and the
    engine's standard {meta, flat} output contract (parallel.mesh), so
    DeviceMapper drains it exactly like the replicated path. `with_hashes`
    adds the matched minimizer hash planes (repeat-filter readback)."""
    join = _sharded_join(mesh, sidx, k, w, max_anchors)
    join_n = _sharded_join(mesh, sidx, k, w, max_anchors, with_nmask=True)
    t_off = sidx.t_off

    def _finish(count, n_mins, rpos_packed, cid, cpos, found, q_hi, q_lo):
        order_flat = jnp.argsort(~found.reshape(-1), stable=True)
        takef = lambda a: a.reshape(-1)[order_flat]
        if t_off is not None:
            gpos = t_off[jnp.maximum(cid, 0)] + cpos.astype(jnp.uint32)
            gplane = jax.lax.bitcast_convert_type(gpos, jnp.int32)
            planes = [takef(rpos_packed), takef(gplane)]
        else:
            planes = [takef(rpos_packed), takef(cid), takef(cpos)]
        if with_hashes:
            planes += [
                takef(q_hi).astype(jnp.int32),
                takef(q_lo).astype(jnp.int32),
            ]
        # meta rides as flat row 0 (same one-object drain contract as the
        # replicated step, parallel.mesh)
        B = count.shape[0]
        meta_row = jnp.zeros_like(planes[0]).at[: 2 * B].set(
            jnp.concatenate([count, n_mins])
        )
        flat = jnp.stack([meta_row] + planes, axis=0)
        return {
            "flat": flat,
            "n_anchors": found.sum(),
        }

    @jax.jit
    def full_step(packed, lengths, t_rows):
        codes = unpack_codes(packed, L)
        return _finish(*join(codes, lengths, t_rows))

    @jax.jit
    def full_step_n(packed, lengths, t_rows, nmask):
        codes = unpack_codes(packed, L)
        return _finish(*join_n(codes, lengths, t_rows, nmask))

    t_rows = jnp.asarray(sidx.t_rows)

    def run(packed, lengths, didx=None, nmask=None):
        if nmask is None:
            return full_step(packed, lengths, t_rows)
        return full_step_n(packed, lengths, t_rows, nmask)

    return run


def make_sharded_index_join(mesh: Mesh, sidx: ShardedDeviceIndex,
                            k: int, w: int, max_anchors: int):
    """Compatibility wrapper over unpacked codes: per-read compacted
    rectangular anchors (count, anchors[pos, cid, cpos, strand_bits])."""
    join = _sharded_join(mesh, sidx, k, w, max_anchors)

    @jax.jit
    def step(codes, lengths, t_rows):
        count, _, rpos_packed, cid, cpos, found, _, _ = join(
            codes, lengths, t_rows
        )
        order = jnp.argsort(~found, axis=1, stable=True)
        take = lambda a: jnp.take_along_axis(a, order, axis=1)
        found_c = take(found)
        m_pos = take(rpos_packed) & 0x1FFFFFFF
        strand_bits = (take(rpos_packed) >> 29) & 3
        anchors = jnp.stack(
            [
                jnp.where(found_c, m_pos, -1),
                jnp.where(found_c, take(cid), -1),
                jnp.where(found_c, take(cpos), -1),
                jnp.where(found_c, strand_bits, 0),
            ],
            axis=1,
        )
        return count, anchors

    t_rows = jnp.asarray(sidx.t_rows)
    return lambda codes, lengths: step(codes, lengths, t_rows)
