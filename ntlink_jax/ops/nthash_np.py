"""Vectorized ntHash2 / indexlr-equivalent sketching — NumPy reference backend.

This is the bit-exact ground truth for the device kernels and for parity with
the reference toolchain's sketch TSVs (validated against every committed golden
`tests/expected_outputs/*.tsv` of the reference repo; see
tests/test_sketch.py). Semantics were reverse-engineered from those goldens:

- seeds: ntHash base constants for A/C/G/T,
- rolling transform: ntHash2 "split rotation" `srol` — the 64-bit word is two
  independently rotating fields, a 31-bit field (bits 33..63) and a 33-bit
  field (bits 0..32),
- forward hash of a k-mer starting at i:  XOR_j srol^(k-1-j)(seed[s[i+j]]),
- reverse hash: forward hash of the reverse complement,
- canonical (minimization key) = (fh + rh) mod 2^64,
- reported strand: '+' iff fh <= rh,
- reported hash = second ntHash multi-hash:
      t = canon * (1 ^ (k * 0x90b45d39fb6da1fa));  t ^= t >> 27
- minimizers: leftmost minimum of each window of `w` consecutive *valid*
  k-mers (k-mers containing non-ACGT are skipped, windows are over the list of
  valid k-mers), consecutive duplicate positions deduplicated.

Everything here is O(n·k) gather+XOR and fully vectorized; the JAX
backends reuse the same precomputed srol tables (as uint32 hi/lo pairs).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

U64 = np.uint64
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# ntHash base seeds (A, C, G, T)
SEEDS = np.array(
    [0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456],
    dtype=np.uint64,
)
MULTISEED = 0x90B45D39FB6DA1FA
MULTISHIFT = 27

# base -> code lookup over raw ASCII; 0..3 = ACGT, 4 = anything else
BASE_CODES = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    BASE_CODES[ord(_c)] = _i
    BASE_CODES[ord(_c.lower())] = _i


def srol(x: np.ndarray, d: int) -> np.ndarray:
    """Apply the ntHash2 split rotation d times to uint64 value(s)."""
    x = np.asarray(x, dtype=np.uint64)
    hi31 = (x >> U64(33)) & U64((1 << 31) - 1)
    lo33 = x & U64((1 << 33) - 1)
    da, db = d % 31, d % 33
    if da:
        hi31 = ((hi31 << U64(da)) | (hi31 >> U64(31 - da))) & U64((1 << 31) - 1)
    if db:
        lo33 = ((lo33 << U64(db)) | (lo33 >> U64(33 - db))) & U64((1 << 33) - 1)
    return (hi31 << U64(33)) | lo33


@lru_cache(maxsize=None)
def srol_tables(k: int):
    """(fwd, rev) lookup tables of shape (k, 5), uint64.

    fwd[j, b] = srol^(k-1-j)(seed[b]); rev[j, b] = srol^j(seed[complement(b)]).
    Column 4 (non-ACGT) is zero — invalid k-mers are masked separately.
    """
    fwd = np.zeros((k, 5), dtype=np.uint64)
    rev = np.zeros((k, 5), dtype=np.uint64)
    for j in range(k):
        for b in range(4):
            fwd[j, b] = srol(SEEDS[b], k - 1 - j)
            rev[j, b] = srol(SEEDS[3 - b], j)
    return fwd, rev


@lru_cache(maxsize=None)
def out_hash_multiplier(k: int) -> np.uint64:
    return np.uint64((1 ^ (k * MULTISEED)) & 0xFFFFFFFFFFFFFFFF)


def encode(seq: str) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..3 = ACGT, 4 = other)."""
    return BASE_CODES[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


@dataclass
class KmerHashes:
    """Per-position k-mer hash data for one sequence (length n-k+1)."""

    out_hash: np.ndarray   # uint64: reported hash (2nd multi-hash)
    canonical: np.ndarray  # uint64: minimization key
    forward: np.ndarray    # bool: True iff fh <= rh ('+' strand)
    valid: np.ndarray      # bool: k-mer contains only ACGT


def hash_kmers_gather(codes: np.ndarray, k: int) -> KmerHashes:
    """O(n·k) gather reference implementation (cross-check for the
    log-doubling fast path below; same bit-exact outputs)."""
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        z = np.zeros(0, dtype=np.uint64)
        b = np.zeros(0, dtype=bool)
        return KmerHashes(z, z.copy(), b, b.copy())

    fwd_tab, rev_tab = srol_tables(k)
    fh = np.zeros(m, dtype=np.uint64)
    rh = np.zeros(m, dtype=np.uint64)
    for j in range(k):
        window = codes[j : j + m]
        fh ^= fwd_tab[j][window]
        rh ^= rev_tab[j][window]
    canonical = (fh + rh) & _MASK64
    return _finish_kmers(codes, k, m, fh, rh, canonical)


_M31 = np.uint64((1 << 31) - 1)
_M33 = np.uint64((1 << 33) - 1)


def _rot_pair(hi: np.ndarray, lo: np.ndarray, d: int):
    """srol^d on split (hi31, lo33) field arrays."""
    da, db = d % 31, d % 33
    if da:
        hi = ((hi << U64(da)) | (hi >> U64(31 - da))) & _M31
    if db:
        lo = ((lo << U64(db)) | (lo >> U64(33 - db))) & _M33
    return hi, lo


def hash_kmers(codes: np.ndarray, k: int) -> KmerHashes:
    """Compute all k-mer hashes for a code array (len >= k).

    Log-doubling over split (hi31, lo33) rotation fields — the same scheme
    as the JAX kernels (sketch_jax.py module docstring) recast as
    whole-array NumPy ufuncs: with F_s(i) the width-s forward hash,
    F_2s(i) = srol^s(F_s(i)) ^ F_s(i+s), so a width-k hash costs
    O(log k) array passes instead of O(k) table gathers — and ufuncs
    release the GIL, so HostMapper threads scale (fancy-index gathers do
    not). Bit-exact vs hash_kmers_gather (see test_sketch.py)."""
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        z = np.zeros(0, dtype=np.uint64)
        b = np.zeros(0, dtype=bool)
        return KmerHashes(z, z.copy(), b, b.copy())

    # width-1 bases (two tiny-table gathers each): S(i) = seed[s(i)],
    # C(i) = seed[complement(s(i))]; column 4 (N) is zero
    seeds5 = np.zeros(5, dtype=np.uint64)
    seeds5[:4] = SEEDS
    comp5 = np.zeros(5, dtype=np.uint64)
    comp5[:4] = SEEDS[::-1]
    s_pack = seeds5[codes]
    c_pack = comp5[codes]
    fh_hi = (s_pack >> U64(33)) & _M31
    fh_lo = s_pack & _M33
    rh_hi = (c_pack >> U64(33)) & _M31
    rh_lo = c_pack & _M33

    # powers[s] = (F_s, R_s) split-field arrays of length n-s+1, for every
    # power-of-two width needed by k's binary decomposition
    cur_w = 1
    saved = {}
    bits = [1 << b for b in range(k.bit_length()) if k & (1 << b)]
    top = 1 << (k.bit_length() - 1)
    while True:
        if cur_w in bits:
            saved[cur_w] = (fh_hi, fh_lo, rh_hi, rh_lo)
        if cur_w >= top:
            break
        s = cur_w
        # F_2s(i) = srol^s(F_s(i)) ^ F_s(i+s)
        a_hi, a_lo = _rot_pair(fh_hi[: -s or None], fh_lo[: -s or None], s)
        fh_hi = a_hi ^ fh_hi[s:]
        fh_lo = a_lo ^ fh_lo[s:]
        # R_2s(i) = R_s(i) ^ srol^s(R_s(i+s))
        b_hi, b_lo = _rot_pair(rh_hi[s:], rh_lo[s:], s)
        rh_hi = rh_hi[: -s or None] ^ b_hi
        rh_lo = rh_lo[: -s or None] ^ b_lo
        cur_w *= 2

    # compose k from its power-of-two blocks, widest first:
    # F_{c+s}(i) = srol^s(F_c(i)) ^ F_s(i+c);  R_{c+s}(i) = R_c(i) ^ srol^c(R_s(i+c))
    fh_hi, fh_lo, rh_hi, rh_lo = saved[top]
    c = top
    for s in sorted((b for b in bits if b != top), reverse=True):
        sf_hi, sf_lo, sr_hi, sr_lo = saved[s]
        new_len = n - (c + s) + 1
        a_hi, a_lo = _rot_pair(fh_hi[:new_len], fh_lo[:new_len], s)
        fh_hi = a_hi ^ sf_hi[c : c + new_len]
        fh_lo = a_lo ^ sf_lo[c : c + new_len]
        b_hi, b_lo = _rot_pair(sr_hi[c : c + new_len], sr_lo[c : c + new_len], c)
        rh_hi = rh_hi[:new_len] ^ b_hi
        rh_lo = rh_lo[:new_len] ^ b_lo
        c += s

    fh = (fh_hi << U64(33)) | fh_lo
    rh = (rh_hi << U64(33)) | rh_lo
    with np.errstate(over="ignore"):
        canonical = fh + rh
    return _finish_kmers(codes, k, m, fh, rh, canonical)


def _finish_kmers(codes, k, m, fh, rh, canonical) -> KmerHashes:
    with np.errstate(over="ignore"):
        t = canonical * out_hash_multiplier(k)
    out = t ^ (t >> np.uint64(MULTISHIFT))

    invalid_base = (codes > 3).astype(np.int32)
    if invalid_base.any():
        # k-mer invalid iff any base in its window is invalid
        csum = np.concatenate(([0], np.cumsum(invalid_base)))
        valid = (csum[k:] - csum[:-k]) == 0
    else:
        valid = np.ones(m, dtype=bool)
    return KmerHashes(out, canonical, fh <= rh, valid)


@dataclass
class Minimizers:
    """Sketch of one sequence: parallel arrays over selected minimizers."""

    hashes: np.ndarray     # uint64 reported (out) hashes
    positions: np.ndarray  # int64 k-mer start positions
    forward: np.ndarray    # bool strand flags

    def __len__(self) -> int:
        return self.positions.shape[0]


def _window_min_positions(keys: np.ndarray, w: int) -> np.ndarray:
    """Leftmost argmin of every length-w window; deduplicated, ascending.

    Sliding minimum via log-doubling over (key, index) lexicographic order:
    after T rounds m[i] = argmin over keys[i:i+2^T]; a window of w is the min
    of two overlapping power-of-two spans.
    """
    m = keys.shape[0]
    if m < w:
        return np.zeros(0, dtype=np.int64)
    idx = np.arange(m, dtype=np.int64)
    key = keys.copy()
    span = 1
    while span * 2 <= w:
        o = span
        lhs_k, rhs_k = key[:-o], key[o:]
        take_r = rhs_k < lhs_k  # strict: ties keep the left (smaller index)
        key = np.concatenate([np.where(take_r, rhs_k, lhs_k), key[-o:]])
        idx = np.concatenate([np.where(take_r, idx[o:], idx[:-o]), idx[-o:]])
        span *= 2
    nwin = m - w + 1
    o = w - span  # second span offset; 0 <= o < span
    lhs_k, rhs_k = key[:nwin], key[o : o + nwin]
    lhs_i, rhs_i = idx[:nwin], idx[o : o + nwin]
    take_r = (rhs_k < lhs_k) | ((rhs_k == lhs_k) & (rhs_i < lhs_i))
    winners = np.where(take_r, rhs_i, lhs_i)
    if winners.size == 0:
        return winners
    keep = np.ones(winners.shape[0], dtype=bool)
    keep[1:] = winners[1:] != winners[:-1]
    return winners[keep]


def sketch_codes(codes: np.ndarray, k: int, w: int) -> Minimizers:
    """Compute the (k, w) minimizer sketch of one encoded sequence."""
    h = hash_kmers(codes, k)
    valid_idx = np.nonzero(h.valid)[0]
    sel = _window_min_positions(h.canonical[valid_idx], w)
    pos = valid_idx[sel]
    return Minimizers(h.out_hash[pos], pos.astype(np.int64), h.forward[pos])


def sketch_sequence(seq: str, k: int, w: int) -> Minimizers:
    return sketch_codes(encode(seq), k, w)
