"""Native TSV index parser == Python parser on reference goldens."""
import glob
import os

import numpy as np
import pytest

import ntlink_jax.native as nat
from ntlink_jax.index import ContigIndex
from ntlink_jax.native import tsv_module


pytestmark = pytest.mark.skipif(
    tsv_module() is None, reason="C build unavailable"
)


def _contig_shape(path):
    with open(path) as fh:
        line = fh.readline()
    parts = line.rstrip("\n").split("\t")
    return (
        len(parts) == 2
        and parts[1]
        and parts[1].split(" ")[0].count(":") == 2
    )


def test_native_tsv_matches_python_on_goldens(golden_dir):
    tsvs = [
        t
        for t in sorted(glob.glob(os.path.join(golden_dir, "*.tsv")))
        if _contig_shape(t)
    ]
    assert tsvs, "no contig-shape golden TSVs found"
    for tsv in tsvs:
        a = ContigIndex.from_tsv(tsv)
        nat._modules["ntlink_tsv"] = None
        try:
            b = ContigIndex.from_tsv(tsv)
        finally:
            nat._modules.pop("ntlink_tsv")
        assert a.contig_names == b.contig_names, tsv
        assert np.array_equal(a.hashes, b.hashes), tsv
        assert np.array_equal(a.contig_ids, b.contig_ids), tsv
        assert np.array_equal(a.positions, b.positions), tsv
        assert np.array_equal(a.strands, b.strands), tsv


def test_native_tsv_tolerates_odd_lines():
    tm = tsv_module()
    buf = (
        b"empty\t\n"
        b"noTab\n"
        b"good\t1:2:+ 3:4:-\n"
        b"extraCol\t99\t5:6:+\n"
        b"crlf\t7:8:-\r\n"
    )
    rows = tm.parse_sketch(buf)
    names = [r[0] for r in rows]
    assert "good" in names
    good = rows[names.index("good")]
    assert good[1] == 2
    assert np.frombuffer(good[2], np.uint64).tolist() == [1, 3]
    assert np.frombuffer(good[3], np.int32).tolist() == [2, 4]
    assert np.frombuffer(good[4], np.uint8).tolist() == [1, 0]
    crlf = rows[names.index("crlf")]
    assert np.frombuffer(crlf[2], np.uint64).tolist() == [7]
    assert np.frombuffer(crlf[4], np.uint8).tolist() == [0]
