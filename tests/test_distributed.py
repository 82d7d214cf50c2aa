"""Multi-host tally merge semantics (single-process exercised)."""
from ntlink_jax.mapping import AnchorHit, ContigRun
from ntlink_jax.pairs import PairTally
from ntlink_jax.parallel.distributed import (
    merge_tallies,
    serialize_tally,
    shard_read_files,
)

LENGTHS = {"A": 5000, "B": 5000}


def mk_tally(gaps):
    t = PairTally(LENGTHS, 32, 10)
    for g in gaps:
        runs = [
            ContigRun("A", [AnchorHit(1, 4000, "+", 100, "+"),
                            AnchorHit(2, 4500, "+", 600, "+")]),
            ContigRun("B", [AnchorHit(3, 100, "+", 600 + 400 + g + 100, "+"),
                            AnchorHit(4, 600, "+", 600 + 400 + g + 600, "+")]),
        ]
        t.add_read(runs, 50000)
    return t


def test_merge_matches_single_host():
    combined = mk_tally([10, 20, 30, 40])
    part1 = mk_tally([10, 20])
    part2 = mk_tally([30, 40])
    merged = merge_tallies(
        PairTally(LENGTHS, 32, 10),
        [serialize_tally(part1), serialize_tally(part2)],
    )
    assert set(merged.pairs) == set(combined.pairs)
    for key in combined.pairs:
        assert merged.pairs[key].gap_estimates == combined.pairs[key].gap_estimates
        assert merged.pairs[key].anchor == combined.pairs[key].anchor
        assert merged.pairs[key].gap_estimate() == combined.pairs[key].gap_estimate()


def test_shard_read_files():
    files = [f"r{i}" for i in range(5)]
    shards = [shard_read_files(files, p, 2) for p in range(2)]
    assert shards[0] == ["r0", "r2", "r4"]
    assert shards[1] == ["r1", "r3"]
    assert sorted(shards[0] + shards[1]) == sorted(files)


def _dir_allgather(base, rank, n, blobs, out, err):
    """Worker: one DirTransport rank doing len(blobs) collectives."""
    from ntlink_jax.parallel.distributed import DirTransport

    try:
        t = DirTransport(base, rank, n, timeout=30.0)
        for blob in blobs:
            out.append(t.allgather(blob))
    except BaseException as exc:  # pragma: no cover - surfaced by assert
        err.append(exc)


def _run_dir_group(base, n, per_rank_blobs):
    import threading

    outs = [[] for _ in range(n)]
    errs = []
    threads = [
        threading.Thread(
            target=_dir_allgather,
            args=(base, r, n, per_rank_blobs[r], outs[r], errs),
        )
        for r in range(n)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs, errs
    return outs


def test_dir_transport_rerun_ignores_stale_blobs(tmp_path):
    """A second run over the same group dir must never consume the first
    run's blobs (fresh per-run namespace; regression for the stale-file
    hazard)."""
    base = str(tmp_path / "group")
    outs1 = _run_dir_group(base, 2, [[b"r0-run1"], [b"r1-run1"]])
    assert outs1[0][0] == [b"r0-run1", b"r1-run1"]
    assert outs1[1][0] == [b"r0-run1", b"r1-run1"]
    # rerun with different payloads: must see ONLY run-2 blobs
    outs2 = _run_dir_group(base, 2, [[b"r0-run2"], [b"r1-run2"]])
    assert outs2[0][0] == [b"r0-run2", b"r1-run2"]
    assert outs2[1][0] == [b"r0-run2", b"r1-run2"]


def test_dir_transport_gc_and_run_id(tmp_path, monkeypatch):
    """Consumed collective blobs are garbage-collected one collective later;
    NTLINK_RUN_ID pins the namespace explicitly."""
    import glob
    import os

    monkeypatch.setenv("NTLINK_RUN_ID", "testrun")
    base = str(tmp_path / "group")
    blobs = [[b"a0", b"b0", b"c0"], [b"a1", b"b1", b"c1"]]
    outs = _run_dir_group(base, 2, blobs)
    assert outs[0] == outs[1] == [
        [b"a0", b"a1"], [b"b0", b"b1"], [b"c0", b"c1"]
    ]
    run_dir = os.path.join(base, "run-testrun")
    assert os.path.isdir(run_dir)
    attempts = glob.glob(os.path.join(run_dir, "attempt-*"))
    assert len(attempts) == 1, attempts
    blobs = sorted(
        os.path.basename(p)
        for p in glob.glob(f"{attempts[0]}/*")
        if os.path.basename(p)[0].isdigit()
    )
    # seq 0 and 1 blobs were GC'd when collectives 1 and 2 completed; only
    # the final collective's blobs remain
    assert blobs == ["2.0", "2.1"], blobs


def test_dir_transport_run_id_rerun_is_isolated(tmp_path, monkeypatch):
    """Reusing the SAME NTLINK_RUN_ID for a second attempt must still never
    consume the first attempt's leftover final-collective blobs (each
    attempt handshakes a fresh namespace under run-<id>)."""
    monkeypatch.setenv("NTLINK_RUN_ID", "pinned")
    base = str(tmp_path / "group")
    outs1 = _run_dir_group(base, 2, [[b"r0-a"], [b"r1-a"]])
    assert outs1[0][0] == [b"r0-a", b"r1-a"]
    outs2 = _run_dir_group(base, 2, [[b"r0-b"], [b"r1-b"]])
    assert outs2[0][0] == [b"r0-b", b"r1-b"]
    assert outs2[1][0] == [b"r0-b", b"r1-b"]
