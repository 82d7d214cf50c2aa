"""JAX device backend for minimizer sketching.

Every 64-bit hash lives as a uint32 (hi, lo) pair, and the kernel is pure
elementwise XOR/shift/carry arithmetic on shifted views of a row, which XLA
fuses into loop kernels:

    fh/rh:    log-doubling sliding XOR — with F_s(i) the width-s forward
              ntHash, F_2s(i) = srol^s(F_s(i)) ^ F_s(i+s) (mirrored for the
              reverse-complement hash), so a width-k hash costs O(log k)
              whole-row ops; srol powers are constant split-rotations on
              unpacked (hi31, bit32, lo32) planes (the width-1 base is a
              3-deep select, not a table gather)
    canon:    64-bit add with carry — returned as the hash planes; the
              reported hash is a bijection of it (`finish_hash`: 64-bit
              constant multiply + xorshift) applied by consumers AFTER
              minimizer compaction, on O(minimizers) elements
    win-min:  O(log w) log-doubling sliding minimum over the (valid, hi, lo)
              key; leftmost tie-break falls out of keep-left-on-ties because
              every combine merges a left range with a right range
    dedup:    consecutive-winner mask

Batches are (B, L) uint8 code tensors padded with 4 (= invalid base); padding
and k-mers containing N are masked invalid. Sequences containing interior N
need btllib's windows-over-valid-kmers semantics, which is a compaction —
handled on-device by the compacted-window kernel
(`sketch_batch_kernel(..., compact_invalid=True)`): invalid k-mers are
squeezed out with a
stable segmented sort so the window minimum runs over valid k-mers only,
bit-exactly matching the NumPy/btllib semantics (see
test_sketch_n.py / test_sketch_jax.py).

The same jitted function drives single-chip and, via `shard_map` over a data
axis (parallel.mesh), multi-chip execution.
"""
from __future__ import annotations

import functools
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import nthash_np
from .nthash_np import Minimizers

MULTISHIFT = 27


@functools.lru_cache(maxsize=None)
def _mult_limbs(k: int) -> np.ndarray:
    """Out-hash multiplier decomposed into 4 uint32-held 16-bit limbs."""
    m = int(nthash_np.out_hash_multiplier(k))
    return np.array(
        [(m >> (16 * i)) & 0xFFFF for i in range(4)], dtype=np.uint32
    )


def mul64_const(hi: jnp.ndarray, lo: jnp.ndarray, limbs: np.ndarray):
    """(hi, lo) * constant (mod 2^64), exact, uint32 lanes only.

    Strategy: 16-bit limbs give products < 2^32. Accumulate per 16-bit
    column in uint32, propagating carries column to column; a column gets at
    most 4 products plus an incoming carry, so the uint32 accumulator would
    overflow — instead fold each product's high half into the next column
    immediately, keeping every accumulator < 2^32.
    """
    a = [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
    b = [int(x) for x in limbs]
    cols = [jnp.zeros_like(lo) for _ in range(5)]
    for i in range(4):
        for j in range(4 - i):
            p = a[i] * jnp.uint32(b[j])  # < 2^32, exact
            c = i + j
            cols[c] = cols[c] + (p & 0xFFFF)
            if c + 1 < 5:
                cols[c + 1] = cols[c + 1] + (p >> 16)
    # carry-propagate (each col now < 4*2^16 + carries, fits easily)
    out = []
    carry = jnp.zeros_like(lo)
    for c in range(4):
        v = cols[c] + carry
        out.append(v & 0xFFFF)
        carry = v >> 16
    new_lo = out[0] | (out[1] << 16)
    new_hi = out[2] | (out[3] << 16)
    return new_hi, new_lo


def finish_hash(can_hi, can_lo, k: int):
    """Canonical -> reported hash (ntHash second multi-hash): a 64-bit
    constant multiply + xorshift, both bijections mod 2^64. Applied by
    consumers after minimizer compaction, so it costs O(minimizers)."""
    t_hi, t_lo = mul64_const(can_hi, can_lo, _mult_limbs(k))
    sh = MULTISHIFT
    out_hi = t_hi ^ (t_hi >> sh)
    out_lo = t_lo ^ ((t_lo >> sh) | (t_hi << (32 - sh)))
    return out_hi, out_lo


def _lex_lt2(a_hi, a_lo, b_hi, b_lo):
    """(hi, lo) strictly-less (uint32 lanes). For the sliding argmin this
    is enough for leftmost tie-break: every combine compares a left-range
    minimum (kept on ties) with a right-range minimum, and the leftmost
    index of a tied value always lives in the left range."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def _shift_left(arr, o, fill):
    """arr[..., i] -> arr[..., i+o], tail filled."""
    return jnp.concatenate(
        [arr[..., o:], jnp.full(arr.shape[:-1] + (o,), fill, arr.dtype)], axis=-1
    )


_M31 = 0x7FFFFFFF


def _shl(x, n: int):
    """x << n for a Python-constant n in [0, 32] (no UB at the edges)."""
    if n == 0:
        return x
    if n >= 32:
        return jnp.zeros_like(x)
    return x << n


def _shr(x, n: int):
    if n == 0:
        return x
    if n >= 32:
        return jnp.zeros_like(x)
    return x >> n


def srol_planes(h31, b32, lo, d: int):
    """Apply srol^d (ntHash2 split rotation: an independently rotating
    31-bit field [bits 33..63] and 33-bit field [bits 0..32]) to the
    unpacked (hi31, bit32, lo32) uint32 planes. d is a Python constant, so
    every shift amount is static (nthash_np.srol is the scalar spec)."""
    a, b = d % 31, d % 33
    if a:
        h31 = ((h31 << a) | (h31 >> (31 - a))) & jnp.uint32(_M31)
    if b:
        # 33-bit field f = b32*2^32 + lo; rot33(f, b) =
        #   ((f << b) | (f >> (33-b))) mod 2^33, as disjoint 32-bit parts
        new_b32 = _shr(lo, 32 - b) & jnp.uint32(1)
        lo = _shl(lo, b) | _shr(lo, 33 - b) | _shl(b32, b - 1)
        b32 = new_b32
    return h31, b32, lo


def select4(code, vals):
    """Map base codes (0..3) to four scalar constants (3-deep select)."""
    c0, c1, c2, c3 = (jnp.uint32(int(v) & 0xFFFFFFFF) for v in vals)
    return jnp.where(
        code == 0, c0, jnp.where(code == 1, c1, jnp.where(code == 2, c2, c3))
    )


@functools.lru_cache(maxsize=None)
def seed_planes():
    """Forward / reverse-complement seeds as (hi31, bit32, lo32) plane
    constants, indexed [plane][base_code]."""
    S = [int(v) for v in nthash_np.SEEDS]

    def planes(vals):
        return (
            [(v >> 33) & _M31 for v in vals],
            [(v >> 32) & 1 for v in vals],
            [v & 0xFFFFFFFF for v in vals],
        )

    return planes(S), planes(S[::-1])


def sliding_hashes(codes, k: int, shift):
    """All-position forward/reverse ntHash2 values via log doubling.

    `shift(plane, o)` moves lane i+o into lane i (any tail semantics —
    positions > L-k receive garbage either way and must be masked by the
    caller). Returns (fh_hi, fh_lo, rh_hi, rh_lo) uint32 planes.

    Identities (F = forward width-s hash, R = reverse):
      F_{2s}(i) = srol^s(F_s(i)) ^ F_s(i+s)
      R_{2s}(i) = R_s(i) ^ srol^s(R_s(i+s))
    and for k = sum of powers 2^b (ascending), right-anchored accumulation
      G_{n+p}(i) = srol^n(F_p(i + k-n-p)) ^ G_n(i)
      H_{n+p}(i) = R_p(i + k-n-p) ^ srol^p(H_n(i))
    folds each power stream the moment it exists — no stream storage.
    """
    f_seeds, r_seeds = seed_planes()
    Fs = [select4(codes, f_seeds[p]) for p in range(3)]
    Rs = [select4(codes, r_seeds[p]) for p in range(3)]
    bits = [1 << b for b in range(32) if (k >> b) & 1]

    s = 1
    done = 0
    accF = accR = None
    for bit in bits:
        while s < bit:
            rf = [shift(p, s) for p in Fs]
            sf = srol_planes(*Fs, s)
            Fs = [a ^ b for a, b in zip(sf, rf)]
            rr = [shift(p, s) for p in Rs]
            sr = srol_planes(*rr, s)
            Rs = [a ^ b for a, b in zip(Rs, sr)]
            s *= 2
        sh = k - done - s
        termF = [shift(p, sh) for p in Fs] if sh else Fs
        if done:
            termF = srol_planes(*termF, done)
        accF = termF if accF is None else [
            a ^ b for a, b in zip(accF, termF)
        ]
        termR = [shift(p, sh) for p in Rs] if sh else Rs
        if accR is None:
            accR = termR
        else:
            accR = [
                a ^ b for a, b in zip(termR, srol_planes(*accR, bit))
            ]
        done += s

    fh_hi = (accF[0] << 1) | accF[1]
    rh_hi = (accR[0] << 1) | accR[1]
    return fh_hi, accF[2], rh_hi, accR[2]


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def sketch_batch_kernel(codes: jnp.ndarray, lengths: jnp.ndarray, k: int, w: int,
                        compact_invalid: bool = False):
    """Sketch a (B, L) uint8 code batch. Returns per-position hash data and
    per-window winners:

      can_hi/can_lo: (B, L) canonical hash halves (apply `finish_hash`
                     after compaction for the reported hash); only columns
                     [0, L-k+1) are meaningful — consumers gather at winner
                     positions, which always fall in that range. (Returning
                     the full row dodges an XLA-CPU pathology where sliced
                     outputs re-fuse and recompute the whole producer chain.)
      fwd:           (B, L) strand flags (fh <= rh), same column scope
      winner:        (B, NW) leftmost argmin position of each window
      emit:          (B, NW) mask: winner differs from previous window's

    `compact_invalid=True` selects the reference N semantics for rows with
    interior non-ACGT bases (indexlr / nthash_np.sketch_codes:176-182): the
    minimizer windows run over the sequence of *valid* k-mers — windows span
    N gaps, and a valid stretch shorter than w emits nothing. Implemented as
    a stable partition of valid k-mers to the row front (one bool argsort +
    gathers), the same positional window-min over the compacted row with the
    per-row valid count as effective length, then winners mapped back to
    original positions. With no interior invalid k-mers the compaction is
    the identity, but costs the argsort — keep it off for clean batches.
    """
    B, L = codes.shape
    M = L - k + 1

    codes_i = codes.astype(jnp.int32)
    shift = lambda p, o: _shift_left(p, o, 0)
    fh_hi, fh_lo, rh_hi, rh_lo = sliding_hashes(codes_i, k, shift)

    # k-mers containing non-ACGT codes: sliding OR of the bad-base mask
    bad = (codes_i > 3).astype(jnp.int32)
    span_n = 1
    while span_n < k:
        o = min(span_n, k - span_n)
        bad = bad | _shift_left(bad, o, 0)
        span_n += o
    invalid_n = bad.astype(jnp.bool_)

    # canonical = fh + rh (mod 2^64)
    can_lo = fh_lo + rh_lo
    carry = (can_lo < fh_lo).astype(jnp.uint32)
    can_hi = fh_hi + rh_hi + carry

    fwd = (fh_hi < rh_hi) | ((fh_hi == rh_hi) & (fh_lo <= rh_lo))

    # mask out k-mers beyond each sequence's end (also covers the garbage
    # the doubling shifts leave at positions > L-k)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    invalid = invalid_n | (pos > (lengths - k)[:, None])

    FULL = jnp.uint32(0xFFFFFFFF)
    key_hi = jnp.where(invalid, FULL, can_hi)
    key_lo = jnp.where(invalid, FULL, can_lo)

    if compact_invalid:
        # stable partition: valid k-mers to the row front in original order
        order = jnp.argsort(invalid, axis=1, stable=True)
        valid_idx = jnp.take_along_axis(pos, order, axis=1)
        key_hi = jnp.take_along_axis(key_hi, order, axis=1)
        key_lo = jnp.take_along_axis(key_lo, order, axis=1)
        n_kmers = (~invalid).sum(axis=1).astype(jnp.int32)
    else:
        n_kmers = jnp.maximum(lengths - k + 1, 0)

    # sliding leftmost-argmin via log-doubling (keep-left on ties)
    m_hi, m_lo = key_hi, key_lo
    m_idx = pos
    span = 1
    while span * 2 <= w:
        o = span
        s_hi = _shift_left(m_hi, o, 0xFFFFFFFF)
        s_lo = _shift_left(m_lo, o, 0xFFFFFFFF)
        s_idx = _shift_left(m_idx, o, jnp.iinfo(jnp.int32).max)
        take = _lex_lt2(s_hi, s_lo, m_hi, m_lo)
        m_hi = jnp.where(take, s_hi, m_hi)
        m_lo = jnp.where(take, s_lo, m_lo)
        m_idx = jnp.where(take, s_idx, m_idx)
        span *= 2
    o = w - span
    NW = M - w + 1
    a_hi, a_lo, a_idx = m_hi[:, :NW], m_lo[:, :NW], m_idx[:, :NW]
    b_hi, b_lo, b_idx = (
        m_hi[:, o : o + NW],
        m_lo[:, o : o + NW],
        m_idx[:, o : o + NW],
    )
    take = _lex_lt2(b_hi, b_lo, a_hi, a_lo)
    winner = jnp.where(take, b_idx, a_idx)
    win_valid = jnp.where(take, b_hi, a_hi) != FULL

    prev = jnp.concatenate(
        [jnp.full((B, 1), -1, winner.dtype), winner[:, :-1]], axis=1
    )
    # a window is fully valid only if it fits inside the (compacted) row
    n_win = jnp.maximum(n_kmers - w + 1, 0)
    wpos = jax.lax.broadcasted_iota(jnp.int32, (B, NW), 1)
    emit = (winner != prev) & (wpos < n_win[:, None]) & win_valid
    if compact_invalid:
        # winners are compacted-row indices: map back to original positions
        winner = jnp.take_along_axis(
            valid_idx, jnp.clip(winner, 0, L - 1), axis=1
        )
    return can_hi, can_lo, fwd, winner, emit




@functools.lru_cache(maxsize=1)
def _sketch_step():
    """Module-level jitted compacted sketch step (shared compile cache)."""
    from ..jax_setup import configure

    configure()
    from ..parallel.mesh import sketch_step_packed

    @functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
    def step(packed, lengths, k, w, L, max_mins, nmask=None):
        return sketch_step_packed(packed, lengths, k, w, L, max_mins, nmask=nmask)

    return step


#: adaptive flat-transfer caps for the sketch path, {(k, w, pad): cap} —
#: keyed by sketch config too: minimizer density scales ~2/(w+1), so a cap
#: learned at w=100 would undershoot ~20x at the overlap pass's w=5 (and a
#: cap learned at w=5 would pin w=100 batches to full-width transfers)
_SKETCH_FLAT_CAPS: dict = {}


class JaxSketcher:
    """Batched device sketcher (NumPy fallback only for sub-k rows).

    N-containing sequences (draft scaffolds are full of N gap runs — the
    primary input of scaffolding rounds >= 2) batch onto the device too, via
    a 1-bit/base non-ACGT mask and the compacted-window kernel variant
    (reference semantics: minimizer windows run over w consecutive *valid*
    k-mers, spanning gaps; nthash_np.sketch_codes is the pinned ground
    truth). Uses the compacted sketch step: device->host transfers are
    O(minimizers), not O(bases).

    Sequences longer than MAX_PAD (whole assembled contigs routinely are:
    the reference sketches multi-Mb drafts through indexlr, ntLink:198-199)
    split into window-aligned chunks that sketch on-device like any other
    row and merge exactly on the host: chunk boundaries are chosen so chunk
    c computes windows [c*S, (c+1)*S) of the full sequence, and the only
    cross-chunk coupling in the algorithm — the consecutive-winner dedup
    `winner != prev` at the first window of a chunk — is re-applied at merge
    time by dropping a chunk's leading minimizer iff it equals the winner of
    the previous chunk's last window (= that chunk's last emitted
    minimizer). Bit-exact vs the unchunked ground truth
    (test_sketch_jax.py::test_long_sequence_chunking)."""

    #: padded length buckets (powers of two keep the jit cache tiny)
    MIN_PAD = 1 << 10
    MAX_PAD = 1 << 21
    MAX_SLOTS = 1 << 17

    def __init__(self, batch_bases: int = 16_000_000):
        self.batch_bases = batch_bases
        # observed-minimizer-volume transfer caps per pad bucket
        # (process-wide so one file's batches teach the next file's)
        self._flat_caps = _SKETCH_FLAT_CAPS
        # rows the device could not sketch (sub-k, N-containing oversized,
        # or minimizer-slot overflow) re-sketched exactly on the host, and
        # rows the device did sketch
        self.host_fallbacks = 0
        self.device_rows = 0

    def _pad_len(self, n: int) -> int:
        p = self.MIN_PAD
        while p < n and p < self.MAX_PAD:
            p <<= 1
        return p

    def _host_sketch(self, codes: np.ndarray, k: int, w: int) -> Minimizers:
        """Exact host fallback: native C rolling sketcher when built (~6x
        the vectorized NumPy hasher, GIL-released), NumPy otherwise."""
        self.host_fallbacks += 1
        from ..native import sketch_module

        sm = sketch_module()
        if sm is not None:
            _, hb, pb, fb = sm.sketch(np.ascontiguousarray(codes), k, w)
            return Minimizers(
                np.frombuffer(hb, np.uint64),
                np.frombuffer(pb, np.int64),
                np.frombuffer(fb, np.uint8).astype(bool),
            )
        return nthash_np.sketch_codes(codes, k, w)

    def _slots_for(self, L: int, w: int) -> int:
        want = int(2.5 * L / (w + 1)) + 64
        s = 128
        while s < want and s < self.MAX_SLOTS:
            s <<= 1
        return s

    def sketch_stream(
        self,
        named_seqs: Iterable[Tuple[str, str]],
        k: int,
        w: int,
    ) -> Iterator[Tuple[str, int, Minimizers]]:
        """Yield (name, length, Minimizers) in input order, batching
        same-bucket sequences onto the device (pipelined flushes)."""
        from ..native import fastx_module
        from ..parallel.mesh import pack_codes

        native = fastx_module()
        step = _sketch_step()
        # per-stream fallback accounting: HybridSketcher restarts this
        # stream on every idle flush, so the summary must report THIS
        # stream's delta, not the instance-cumulative count
        fallbacks_at_start = self.host_fallbacks

        # same feeder/drainer pipeline as device_map.map_stream_raw: the
        # feeder owns every device call (per-dispatch link round trips
        # overlap the main thread's reading/packing/TSV rendering), the
        # drainer owns the blocking D2H waits (jax releases the GIL there)
        from ..stream_pipeline import (
            DevicePipeline,
            finish_flat_stream,
            split_n_rows,
            start_flat_stream,
        )

        pending: List[Tuple[str, int]] = []   # (name, length)
        #: per-chunk outputs, keyed (seq_idx, chunk_idx)
        results: Dict[Tuple[int, int], Minimizers] = {}
        encoded: Dict[Tuple[int, int], np.ndarray] = {}
        #: (pad, has_n) -> [(seq_idx, chunk_idx, base_offset), ...]
        buckets: Dict[tuple, List[tuple]] = {}
        n_chunks: Dict[int, int] = {}  # seq_idx -> chunk count (1 = whole)
        next_yield = [0]  # front of the in-order delivery window

        def bucket_rows(pad: int) -> int:
            b = 1
            while b < max(1, self.batch_bases // pad):
                b <<= 1
            return b

        def flush_bucket(key: tuple, idxs: List[tuple]) -> None:
            pad, has_n = key
            B = bucket_rows(pad)
            assert len(idxs) <= B
            row_codes = [encoded.pop((i, ci)) for i, ci, _ in idxs]
            lengths = np.zeros(B, dtype=np.int32)
            lengths[: len(idxs)] = [len(c) for c in row_codes]
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
            pipe.submit(
                (packed, nmask, lengths, pad, dict(enumerate(idxs)), row_codes, B)
            )

        def dispatch_batch(packed, nmask, lengths, pad, rows, row_codes, B) -> None:
            # N batches take the compacted-window kernel variant
            out = step(
                jnp.asarray(packed), jnp.asarray(lengths), k, w, pad,
                self._slots_for(pad, w),
                None if nmask is None else jnp.asarray(nmask),
            )
            # adaptive capped-transfer protocol (shared with the mapping
            # stream): meta + minimizer prefix start streaming now, async
            sliced = start_flat_stream(out, self._flat_caps, (k, w, pad))
            pipe.submit_drain((out, sliced, pad, rows, row_codes, B))

        def drain(out, sliced, pad, rows, row_codes, B) -> None:
            meta = np.asarray(out["meta"])
            count, n_mins = meta[:B], meta[B:]
            slots = int(out["flat"].shape[1]) // B
            offs, total, flat, _r16 = finish_flat_stream(
                out, sliced, count, B, len(rows), self._flat_caps,
                (k, w, pad),
            )
            for row, (i, ci, base_off) in rows.items():
                n = int(count[row])
                if n_mins[row] > slots:
                    m = self._host_sketch(row_codes[row], k, w)
                    results[(i, ci)] = (
                        Minimizers(m.hashes, m.positions + base_off, m.forward)
                        if base_off
                        else m
                    )
                    continue
                self.device_rows += 1
                if n == 0:
                    results[(i, ci)] = Minimizers(
                        np.zeros(0, np.uint64), np.zeros(0, np.int64),
                        np.zeros(0, bool),
                    )
                    continue
                o = int(offs[row])
                hashes = (
                    (flat[1, o : o + n].view(np.uint32).astype(np.uint64)
                     << np.uint64(32))
                    | flat[2, o : o + n].view(np.uint32).astype(np.uint64)
                )
                pos_strand = flat[0, o : o + n]
                results[(i, ci)] = Minimizers(
                    hashes,
                    (pos_strand & 0x3FFFFFFF).astype(np.int64) + base_off,
                    (pos_strand >> 30).astype(bool),
                )

        pipe = DevicePipeline(dispatch_batch, drain, name="ntlink-sk")

        def merged(i: int) -> Minimizers:
            nc = n_chunks[i]
            if nc == 1:
                return results.pop((i, 0))
            # exact cross-chunk dedup: the full-sequence kernel emits at
            # window j iff winner(j) != winner(j-1); a chunk's first window
            # always emits (no prev), so drop it iff it equals the previous
            # chunk's last-window winner — which is that chunk's last
            # emitted minimizer BEFORE any seam trim of its own
            hs, ps, fs = [], [], []
            prev_last = -1
            for ci in range(nc):
                m = results.pop((i, ci))
                h, po, f = m.hashes, m.positions, m.forward
                if len(po) and len(ps) and int(po[0]) == prev_last:
                    h, po, f = h[1:], po[1:], f[1:]
                if len(m.positions):
                    prev_last = int(m.positions[-1])
                hs.append(h)
                ps.append(po)
                fs.append(f)
            return Minimizers(
                np.concatenate(hs), np.concatenate(ps), np.concatenate(fs)
            )

        def have_all(i: int) -> bool:
            nc = n_chunks.get(i, 1)
            if nc == 1:
                return (i, 0) in results
            return all((i, ci) in results for ci in range(nc))

        def ready_results():
            # deliver strictly in input order as soon as a batch drains, so
            # the consumer's TSV rendering / downstream work overlaps later
            # batches' wire+device time (drainer only ADDS keys, main pops)
            i = next_yield[0]
            while i < len(pending) and have_all(i):
                name, length = pending[i]
                pending[i] = None
                yield name, length, merged(i)
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
                yield name, length, merged(i)
            pending.clear()
            results.clear()
            n_chunks.clear()
            next_yield[0] = 0

        def enqueue_chunk(i: int, ci: int, codes: np.ndarray, off: int,
                          has_n: bool) -> int:
            """Bucket one device row; returns its padded length."""
            encoded[(i, ci)] = codes
            pad = self._pad_len(len(codes))
            key = (pad, has_n)
            bucket = buckets.setdefault(key, [])
            bucket.append((i, ci, off))
            if len(bucket) >= bucket_rows(pad):
                flush_bucket(key, bucket)
                buckets[key] = []
            return pad

        try:
            budget = 0
            for name, seq in named_seqs:
                i = len(pending)
                pending.append((name, len(seq)))
                codes = (
                    seq if isinstance(seq, np.ndarray) else nthash_np.encode(seq)
                )
                has_n = bool((codes > 3).any())
                if len(codes) < k or (len(codes) > self.MAX_PAD and has_n):
                    # host path: sub-k rows (no windows), and oversized
                    # N-containing rows (chunk seams do not compose with
                    # the compacted-window semantics) — native C sketcher
                    n_chunks[i] = 1
                    results[(i, 0)] = self._host_sketch(codes, k, w)
                    yield from ready_results()
                    continue
                if len(codes) > self.MAX_PAD:
                    # window-aligned chunks: chunk c computes windows
                    # [c*S, (c+1)*S); interior chunks are exactly MAX_PAD
                    # bases (zero pad waste), merged() re-applies the
                    # cross-chunk winner dedup
                    S = self.MAX_PAD - (k + w - 2)
                    M = len(codes) - (k + w - 2)  # total windows
                    nc = (M + S - 1) // S
                    n_chunks[i] = nc
                    for ci in range(nc):
                        lo = ci * S
                        hi = min(lo + S, M) + (k + w - 2)
                        budget += enqueue_chunk(
                            i, ci, codes[lo:hi], lo, False
                        )
                else:
                    # N-containing rows (draft scaffolds' gap runs) batch
                    # separately: compacted-window XLA kernel + 1-bit N mask
                    n_chunks[i] = 1
                    budget += enqueue_chunk(i, 0, codes, 0, has_n)
                yield from ready_results()
                if budget >= 4 * self.batch_bases:
                    yield from flush_all()
                    budget = 0
            yield from flush_all()
        finally:
            pipe.close()
            stream_fallbacks = self.host_fallbacks - fallbacks_at_start
            if stream_fallbacks:
                import sys

                print(
                    f"# ntlink sketch: {stream_fallbacks} row(s) took "
                    f"the exact host fallback path (sub-k, oversized with "
                    f"N, or minimizer-slot overflow)",
                    file=sys.stderr,
                )
