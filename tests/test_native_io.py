"""Native C reader parity vs the pure-Python readfq parser."""
import os

import numpy as np
import pytest

from ntlink_jax.ops import nthash_np
from ntlink_jax.seqio import stream_fastx
from ntlink_jax.seqio.fastx import stream_codes, _parse, open_text_maybe_gzip


FILES = [
    "scaffolds_1.fa",
    "scaffolds_4.fa",
    "long_reads_1.fa",
    "long_reads_2.fq.gz",
    "long_reads_3.fa.gz",
]


def python_records(path):
    fh = open_text_maybe_gzip(path)
    try:
        return [(r.name, r.seq, r.comment, r.qual) for r in _parse(fh)]
    finally:
        fh.close()


@pytest.mark.parametrize("fname", FILES)
def test_native_reader_matches_python(ref_tests_dir, fname):
    path = os.path.join(ref_tests_dir, fname)
    native = [(r.name, r.seq, r.comment, r.qual) for r in stream_fastx(path)]
    ref = python_records(path)
    assert len(native) == len(ref)
    for a, b in zip(native, ref):
        assert a == b


@pytest.mark.parametrize("fname", ["long_reads_1.fa", "long_reads_2.fq.gz"])
def test_stream_codes_matches_encode(ref_tests_dir, fname):
    path = os.path.join(ref_tests_dir, fname)
    ref = [(r.name, nthash_np.encode(r.seq)) for r in stream_fastx(path)]
    got = list(stream_codes(path))
    assert len(got) == len(ref)
    for (gn, gc), (rn, rc) in zip(got, ref):
        assert gn == rn
        assert np.array_equal(gc, rc)


def test_weird_records(tmp_path):
    # multi-line fasta, empty seq, fastq with multi-line quality
    p = tmp_path / "x.fq"
    p.write_text(
        ">a comment here\nACGT\nACGT\n"
        ">empty\n"
        "@q1\nACGTNacgt\n+\nIIIII\nIIII\n"
        "@q2 trailing\nACGT\n+ignored\nIIII\n"
    )
    native = [(r.name, r.seq, r.comment, r.qual) for r in stream_fastx(str(p))]
    ref = python_records(str(p))
    assert native == ref


def test_prefetch_files_order_and_parity(tmp_path):
    """Parallel multi-file prefetch yields files in input order with the
    same records as serial reads (the pigz-equivalent must not perturb any
    order-sensitive artifact)."""
    import gzip

    from ntlink_jax.seqio.fastx import prefetch_files

    paths = []
    for i in range(5):
        p = str(tmp_path / f"r{i}.fa.gz")
        with gzip.open(p, "wt") as fh:
            for j in range(50):
                fh.write(f">f{i}_r{j}\n{'ACGT' * (10 + j)}\n")
        paths.append(p)

    serial = [
        (p, [(r.name, r.seq) for r in stream_fastx(p)]) for p in paths
    ]
    for threads in (1, 3, 8):
        got = [
            (p, [(r.name, r.seq) for r in it])
            for p, it in prefetch_files(paths, stream_fastx, threads=threads)
        ]
        assert got == serial, f"threads={threads}"


def test_prefetch_files_propagates_exceptions(tmp_path):
    from ntlink_jax.seqio.fastx import prefetch_files

    ok = str(tmp_path / "ok.fa")
    with open(ok, "w") as fh:
        fh.write(">a\nACGT\n")
    missing = str(tmp_path / "missing.fa")

    results = prefetch_files([ok, missing], stream_fastx, threads=2)
    p, it = next(results)
    assert [r.name for r in it] == ["a"]
    p, it = next(results)
    with pytest.raises(Exception):
        list(it)


@pytest.mark.parametrize("with_strand", [True, False])
def test_native_minimizer_render_matches_python(with_strand):
    """C render_minimizers == the Python TSV body formatter, byte for byte,
    including 64-bit-boundary hash values and empty input."""
    import numpy as np

    from ntlink_jax.ops.nthash_np import Minimizers
    from ntlink_jax.sketch import format_minimizers, format_minimizers_bytes

    rng = np.random.default_rng(9)
    hashes = np.concatenate(
        [
            rng.integers(0, 2**63, 500, dtype=np.uint64) * np.uint64(2),
            np.array([0, 1, 2**63, 2**64 - 1, 10**19], dtype=np.uint64),
        ]
    )
    n = len(hashes)
    mins = Minimizers(
        hashes,
        np.sort(rng.integers(0, 2**31, n)).astype(np.int64),
        rng.integers(0, 2, n).astype(bool),
    )
    got = format_minimizers_bytes(mins, with_strand=with_strand)
    exp = format_minimizers(mins, with_strand=with_strand).encode()
    assert got == exp

    empty = Minimizers(
        np.zeros(0, np.uint64), np.zeros(0, np.int64), np.zeros(0, bool)
    )
    assert format_minimizers_bytes(empty, with_strand=with_strand) == b""


def test_prefetch_files_abandonment_releases_workers(tmp_path):
    """If the consumer stops mid-stream (an error elsewhere), blocked
    workers must unblock and exit instead of pinning queues/handles for the
    life of the process (regression: run_rounds loops in one process)."""
    import threading
    import time

    from ntlink_jax.seqio.fastx import prefetch_files

    paths = []
    for i in range(3):
        p = tmp_path / f"r{i}.fa"
        with open(p, "w") as fh:
            for j in range(500):
                fh.write(f">s{j}\nACGTACGTAC\n")
        paths.append(str(p))

    n_before = threading.active_count()
    gen = prefetch_files(paths, stream_fastx, threads=3, depth=4)
    path, it = next(gen)
    next(it)  # consume one record, then abandon everything
    gen.close()
    deadline = time.time() + 10
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before, "prefetch workers leaked"
