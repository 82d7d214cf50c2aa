"""Hash-sharded index join on a 2-D (data, idx) CPU mesh vs ground truth."""
import numpy as np

import jax
from jax.sharding import Mesh

from ntlink_jax.index import ContigIndex
from ntlink_jax.ops import nthash_np
from ntlink_jax.parallel.sharded_index import (
    ShardedDeviceIndex,
    make_sharded_index_join,
)


def test_sharded_join_matches_replicated_lookup():
    assert len(jax.devices()) == 8
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "idx"))
    k, w = 32, 100
    rng = np.random.default_rng(3)
    contigs = [
        ("c%d" % i, "".join(np.array(list("ACGT"))[rng.integers(0, 4, 20000)]))
        for i in range(3)
    ]
    index = ContigIndex.from_sketches(
        (n, nthash_np.sketch_sequence(s, k, w)) for n, s in contigs
    )
    sidx = ShardedDeviceIndex.from_contig_index(index, n_shards=4)
    join = make_sharded_index_join(mesh, sidx, k, w, max_anchors=512)

    # reads: slices of contigs (guaranteed hits) + random (mostly misses)
    B, L = 4, 8192
    codes = np.zeros((B, L), np.uint8)
    for r in range(B - 1):
        src = contigs[r % 3][1]
        start = 1000 * r
        codes[r] = nthash_np.encode(src[start : start + L])
    # last row: half contig slice, half random (partial matches exercise
    # the on-device compaction)
    half = nthash_np.encode(contigs[0][1][:L // 2])
    codes[B - 1, : L // 2] = half
    codes[B - 1, L // 2 :] = rng.integers(0, 4, L - L // 2).astype(np.uint8)
    lengths = np.full(B, L, np.int32)

    count, anchors = join(codes, lengths)
    count = np.asarray(count)
    anchors = np.asarray(anchors)

    for r in range(B):
        mins = nthash_np.sketch_codes(codes[r], k, w)
        found, cid, cpos, cstrand = index.lookup_many(mins.hashes)
        exp_pos = mins.positions[found]
        exp_cid = cid[found]
        exp_cpos = cpos[found]
        n = int(count[r])
        assert n == exp_pos.shape[0], f"row {r}"
        got = anchors[r]
        assert np.array_equal(got[0, :n], exp_pos), f"row {r} positions"
        assert np.array_equal(got[1, :n], exp_cid), f"row {r} cids"
        assert np.array_equal(got[2, :n], exp_cpos), f"row {r} cpos"
        exp_bits = cstrand[found].astype(np.int32) | (
            mins.forward[found].astype(np.int32) << 1
        )
        assert np.array_equal(got[3, :n], exp_bits), f"row {r} strands"


import pytest


@pytest.mark.parametrize("repeats", [False, True])
def test_pair_stage_hash_sharded_matches_replicated(ref_tests_dir, tmp_path, monkeypatch, repeats):
    """Full pair stage with index_sharding=hash on the 2-D virtual mesh ==
    the replicated-index outputs bit for bit; repeats=True exercises the
    matched-hash readback planes through the sharded join."""
    import filecmp
    import os
    import shutil

    from ntlink_jax.config import ScaffoldConfig
    from ntlink_jax.pipeline import pair_stage

    outputs = {}
    for sharding in ("replicated", "hash"):
        d = tmp_path / sharding
        os.makedirs(d)
        for f in ("scaffolds_1.fa", "long_reads_1.fa"):
            shutil.copy(os.path.join(ref_tests_dir, f), d)
        monkeypatch.chdir(d)
        cfg = ScaffoldConfig(
            target="scaffolds_1.fa", reads=["long_reads_1.fa"], k=32, w=250,
            z=1000, pairs_tsv=True, backend="jax", batch_bases=2_000_000,
            index_sharding=sharding, idx_shards=4, repeats=repeats,
        )
        pair_stage(cfg)
        outputs[sharding] = d

    prefix = "scaffolds_1.fa.k32.w250.z1000"
    for artifact in (
        f"{prefix}.verbose_mapping.tsv",
        f"{prefix}.pairs.tsv",
        f"{prefix}.n1.scaffold.dot",
    ):
        assert filecmp.cmp(
            outputs["replicated"] / artifact,
            outputs["hash"] / artifact,
            shallow=False,
        ), artifact


def test_dryrun_sharded_index():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__

    __graft_entry__.dryrun_sharded_index(8)
