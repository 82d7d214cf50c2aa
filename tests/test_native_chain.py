"""Property test: native C chainer == Python chaining, including verbose."""
import numpy as np
import pytest

from ntlink_jax.mapping import AnchorHit, chain_read_hits
from ntlink_jax.native import chain_module


@pytest.mark.parametrize("sensitive", [False, True])
@pytest.mark.parametrize("x", [0.0, 1.5])
def test_chainer_matches_python(sensitive, x):
    mod = chain_module()
    assert mod is not None
    rng = np.random.default_rng(int(sensitive) * 2 + int(x))
    n_contigs = 6
    names = [f"ctg{i}" for i in range(n_contigs)]
    clen = rng.integers(400, 6000, size=n_contigs).astype(np.int32)
    lengths = {names[i]: int(clen[i]) for i in range(n_contigs)}
    chainer = mod.Chainer(clen, names)

    for trial in range(200):
        n = int(rng.integers(1, 40))
        cid = rng.integers(0, n_contigs, size=n).astype(np.int32)
        cpos = rng.integers(0, 6000, size=n).astype(np.int32)
        rpos = np.sort(rng.integers(0, 4000, size=n)).astype(np.int32)
        sbits = rng.integers(0, 4, size=n).astype(np.int32)
        read_len = int(rng.integers(500, 5000))

        hits = [
            (
                names[c],
                AnchorHit(0, int(p), "+" if b & 1 else "-", int(r),
                          "+" if b & 2 else "-"),
            )
            for c, p, r, b in zip(cid, cpos, rpos, sbits)
        ]
        expected = chain_read_hits(
            hits, read_len, lengths, k=32, z=1000, x=x, sensitive=sensitive
        )
        runs_raw, vbytes = chainer.chain(
            cid, cpos, rpos, sbits, n, read_len, 32, 1000,
            1 if sensitive else 0, x, "r%d" % trial,
        )
        assert len(runs_raw) == len(expected), f"trial {trial}"
        exp_verbose = "".join(
            f"r{trial}\t{run.contig}\t{run.hit_count}\t{run.hits_string()}\n"
            for run in expected
        )
        got_verbose = vbytes.decode() if vbytes is not None else ""
        assert got_verbose == exp_verbose, f"trial {trial}"
        for got, run in zip(runs_raw, expected):
            c, cnt, fc, fr, fb, lc, lr, lb = got
            assert names[c] == run.contig
            assert cnt == run.hit_count
            assert (fc, fr) == (run.first_hit.ctg_pos, run.first_hit.read_pos)
            assert (lc, lr) == (run.terminal_hit.ctg_pos, run.terminal_hit.read_pos)


@pytest.mark.parametrize("sensitive", [False, True])
def test_chain_batch_matches_per_read(sensitive):
    """chain_batch over a random group == per-read chain calls, including
    the concatenated verbose blob and empty/anchored-elsewhere reads."""
    mod = chain_module()
    assert mod is not None
    rng = np.random.default_rng(11 + int(sensitive))
    n_contigs = 8
    names = [f"ctg{i}" for i in range(n_contigs)]
    clen = rng.integers(400, 6000, size=n_contigs).astype(np.int32)
    chainer = mod.Chainer(clen, names)

    n_reads = 120
    per_read = []
    read_lens = []
    for _ in range(n_reads):
        n = int(rng.integers(0, 30))  # some reads have zero anchors
        cid = rng.integers(0, n_contigs, size=n).astype(np.int32)
        cpos = rng.integers(0, 6000, size=n).astype(np.int32)
        rpos = np.sort(rng.integers(0, 4000, size=n)).astype(np.int32)
        sbits = rng.integers(0, 4, size=n).astype(np.int32)
        per_read.append((cid, cpos, rpos, sbits))
        read_lens.append(int(rng.integers(500, 5000)))

    offs = np.zeros(n_reads + 1, np.int64)
    for i, (cid, _, _, _) in enumerate(per_read):
        offs[i + 1] = offs[i] + len(cid)
    cat = lambda j: np.concatenate([p[j] for p in per_read]).astype(np.int32)
    rnames = [f"read{i}" for i in range(n_reads)]
    runs_b, ro_b, vbytes, _paf = chainer.chain_batch(
        cat(0), cat(1), cat(2), cat(3), offs,
        np.asarray(read_lens, np.int32), rnames,
        32, 1000, 1 if sensitive else 0, 0.5,
    )
    runs_arr = np.frombuffer(runs_b, np.int32).reshape(-1, 8)
    ro = np.frombuffer(ro_b, np.int32)
    assert ro[0] == 0 and ro[-1] == runs_arr.shape[0]

    exp_verbose = b""
    for i, (cid, cpos, rpos, sbits) in enumerate(per_read):
        exp_runs, exp_v = chainer.chain(
            cid, cpos, rpos, sbits, len(cid), read_lens[i], 32, 1000,
            1 if sensitive else 0, 0.5, rnames[i],
        )
        got = runs_arr[ro[i] : ro[i + 1]]
        assert len(got) == len(exp_runs), f"read {i}"
        for row, exp in zip(got, exp_runs):
            assert tuple(row) == exp, f"read {i}"
        if exp_v is not None:
            exp_verbose += exp_v
    assert vbytes == exp_verbose
