"""Global-position (gpos) anchor-payload packing: the uint32 plane that
replaces separate (cid, cpos) planes on the device->host stream
(mesh.build_gpos_offsets / DeviceIndex.decode_gpos), and its automatic
shutoff past the uint32 span limit — plus the quarter-pow2 transfer-cap
quantizer it ships with."""
import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from ntlink_jax.parallel.mesh import (  # noqa: E402
    DeviceIndex,
    build_gpos_offsets,
    mapping_step_packed,
    pack_codes,
)
from ntlink_jax.ops import nthash_np  # noqa: E402
from ntlink_jax.stream_pipeline import next_q4  # noqa: E402


def test_next_q4_tight_and_monotonic():
    for n in list(range(1, 600)) + [4095, 4096, 4097, 81920, 99_000, 1 << 20]:
        q = next_q4(n)
        assert q >= n
        if n > 4:
            assert q < 1.25 * n + 1, (n, q)  # worst-case overshoot bound
        assert next_q4(q) == q  # idempotent (quantized values are fixed)


def test_gpos_offsets_roundtrip_and_empty_contigs():
    # contig 1 has no minimizers: its zero span must not break the inverse
    cids = np.array([0, 0, 2, 2, 2], np.int32)
    poss = np.array([5, 17, 0, 3, 99], np.int32)
    offsets, pack, t_off = build_gpos_offsets(cids, poss, len(cids))
    assert pack and t_off is not None
    off = np.asarray(t_off).astype(np.int64)
    gpos = off[cids] + poss
    idx = np.searchsorted(offsets, gpos, side="right") - 1
    assert np.array_equal(idx, cids)
    assert np.array_equal(gpos - offsets[idx], poss)


def test_gpos_disabled_past_uint32_span():
    # two contigs whose indexed spans sum past 2^32: packing must turn off
    cids = np.array([0, 1], np.int32)
    poss = np.array([2**31 - 1, 2**31 - 1], np.int32)
    offsets, pack, t_off = build_gpos_offsets(cids, poss, 2)
    assert offsets[-1] > 0xFFFFFFFF
    assert not pack and t_off is None


def _mini_workload(k=32, w=50, L=2048, B=8, seed=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = np.full(B, L, np.int32)
    mins = nthash_np.sketch_codes(codes[0], k, w)
    didx = DeviceIndex(
        mins.hashes,
        np.zeros(len(mins), np.int32),
        mins.positions.astype(np.int32),
        mins.forward,
    )
    return codes, lengths, mins, didx, k, w, L


@pytest.mark.parametrize("use_gpos", [True, False])
def test_mapping_step_plane_layouts_agree(use_gpos):
    """The 2-plane gpos layout and the 3-plane (cid, cpos) layout must
    decode to identical anchors — the >4.3 Gb fallback is exercised by
    forcing t_off=None on the same index."""
    codes, lengths, mins, didx, k, w, L = _mini_workload()
    S = 256
    out = jax.jit(
        lambda p, l: mapping_step_packed(
            p, l, didx.t_bkt, k, w, L, didx.mask, didx.max_probes, S,
            with_hashes=False,
            t_off=didx.t_off if use_gpos else None,
        )
    )(jnp.asarray(pack_codes(codes)), jnp.asarray(lengths))
    # meta (per-row counts | n_minimizers) rides as flat row 0 so the
    # batch drains as one D2H object; payload planes follow
    full = np.asarray(out["flat"])
    count = full[0, : codes.shape[0]]
    flat = full[1:]
    total = int(count.sum())
    assert total >= len(mins)  # row 0 is the indexed sequence itself
    # pads <= 16384 ship read positions as the separate uint16 stream
    # ("r16", strand bits at 14/15); the int32 plane-0 layout remains for
    # larger pads
    assert "r16" in out
    r16 = np.asarray(out["r16"]).view(np.uint16)
    if use_gpos:
        assert flat.shape[0] == 1
        cid, cpos = didx.decode_gpos(flat[0, :total])
    else:
        assert flat.shape[0] == 2
        cid, cpos = flat[0, :total], flat[1, :total]
    # row 0's anchors are exactly its index entries, in read order
    n0 = int(count[0])
    rpos = (r16[:n0] & 0x3FFF).astype(np.int64)
    assert np.array_equal(rpos, mins.positions.astype(np.int64)[: len(rpos)])
    assert (cid[:n0] == 0).all()
    assert np.array_equal(cpos[:n0], mins.positions.astype(np.int32)[:n0])
