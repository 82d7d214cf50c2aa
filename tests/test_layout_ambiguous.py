"""Ambiguous-graph layout: tips, repeats, weak edges (ABySS Scaffold
heuristics — reference invokes abyss-scaffold at ntLink:228-231; no golden
exercises branchy graphs, so these synthetic adversarial cases pin the
behavior and prove the engine lays out at least as well as the previous
unambiguous-chains-only layout)."""
from ntlink_jax.graphio import EdgeAttr, ScaffoldGraph
from ntlink_jax.layout import (
    assemble_paths,
    flip_node,
    layout,
    prune_tips,
    remove_repeats,
    remove_weak_edges,
    resolve_ambiguities,
)


def add_pair(g, u, v, n=3, d=100):
    """Add an oriented link and its reverse-complement twin."""
    g.add_edge(u, v, EdgeAttr(d=d, n=n))
    g.add_edge(flip_node(v), flip_node(u), EdgeAttr(d=d, n=n))


def build(edges, lengths=None):
    g = ScaffoldGraph()
    for e in edges:
        add_pair(g, *e)
    for name in list(g.nodes()):
        g.node_lengths[name] = (lengths or {}).get(name[:-1], 5000)
    return g


def path_sets(paths):
    return {tuple(p.nodes) for p in paths}


def canonical(paths):
    """One representative per RC twin pair."""
    out = set()
    for p in paths:
        fwd = tuple(p.nodes)
        rev = tuple(flip_node(n) for n in reversed(p.nodes))
        out.add(min(fwd, rev))
    return out


def test_tip_pruned_chain_continues():
    # A -> B -> C with a spurious dead-end branch B -> T
    g = build([("A+", "B+", 5), ("B+", "C+", 5), ("B+", "T+", 1)])
    assert prune_tips(g) == 1
    paths = assemble_paths(g, min_gap=20)
    assert canonical(paths) == {("A+", "B+", "C+")}


def test_all_tip_fork_keeps_best_supported():
    g = build([("A+", "B+", 5), ("B+", "T1+", 5), ("B+", "T2+", 1)])
    prune_tips(g)
    paths = assemble_paths(g, min_gap=20)
    assert canonical(paths) == {("A+", "B+", "T1+")}


def test_all_tip_fork_tie_is_conservative():
    g = build([("A+", "B+", 5), ("B+", "T1+", 2), ("B+", "T2+", 2)])
    assert prune_tips(g) == 0
    paths = assemble_paths(g, min_gap=20)
    # B keeps both tips: only A-B links
    assert canonical(paths) == {("A+", "B+")}


def test_weak_edge_dominated_both_ends_removed():
    # two real chains A->B and C->D plus a weak chimeric link A->D
    g = build([("A+", "B+", 5), ("C+", "D+", 4), ("A+", "D+", 1)])
    assert remove_weak_edges(g) == 2  # the edge and its RC twin snapshot
    paths = assemble_paths(g, min_gap=20)
    assert canonical(paths) == {("A+", "B+"), ("C+", "D+")}


def test_weak_edge_tie_survives():
    g = build([("A+", "B+", 5), ("C+", "D+", 4), ("A+", "D+", 5)])
    assert remove_weak_edges(g) == 0
    # ambiguity remains: no false joins either way
    paths = assemble_paths(g, min_gap=20)
    assert canonical(paths) == {("C+", "D+")} or paths == []


def test_repeat_vertex_cleared_unblocks_neighbor():
    # A links to both a repeat R (in 2 / out 2) and its true successor B;
    # clearing R leaves A -> B unambiguous
    g = build(
        [
            ("A+", "R+", 3),
            ("X+", "R+", 3),
            ("R+", "Y+", 3),
            ("R+", "Z+", 3),
            ("A+", "B+", 3),
        ]
    )
    cleared = remove_repeats(g)
    assert cleared == ["R+"]
    assert g.out_degree("R+") == 0 and g.in_degree("R+") == 0
    assert g.out_degree("R-") == 0 and g.in_degree("R-") == 0
    paths = assemble_paths(g, min_gap=20)
    assert ("A+", "B+") in canonical(paths)


def test_rc_symmetry_preserved():
    g = build(
        [
            ("A+", "B+", 5),
            ("B+", "C+", 5),
            ("B+", "T+", 1),
            ("A+", "D-", 1),
            ("E-", "D-", 4),
            ("Q+", "R+", 3),
            ("X+", "R+", 3),
            ("R+", "Y+", 3),
            ("R+", "Z+", 3),
        ]
    )
    resolve_ambiguities(g)
    for u, v, _ in g.edges():
        assert g.has_edge(flip_node(v), flip_node(u)), (u, v)


def test_layout_end_to_end_with_noise_beats_conservative():
    """Full layout() on a noisy graph: the heuristics recover the 4-contig
    backbone that unambiguous-chains-only layout would shatter."""
    edges = [
        ("A+", "B+", 6),
        ("B+", "C+", 6),
        ("C+", "D+", 6),
        ("B+", "T+", 1),   # tip off the backbone
        ("E+", "C+", 1),   # weak chimeric link into C (dominated both ends)
        ("E+", "F+", 4),
    ]
    g = build(edges)
    lengths = {n[:-1]: 5000 for n in g.nodes()}
    res = layout(g, lengths, min_weight=1, seed_length=100, min_gap=20)
    joined = canonical(res.paths)
    assert ("A+", "B+", "C+", "D+") in joined
    assert ("E+", "F+") in joined
    # N50 with the backbone joined: 4 contigs in one scaffold
    ls = sorted(res.scaffold_lengths(lengths), reverse=True)
    assert ls[0] == 4 * 5000


def test_transitive_reduction_dense_graph_stays_fast():
    """Realistic noisy regimes (local branch noise on a backbone; repeat
    hubs with many long links): one reduction stays around a second, and
    the parallel n-sweep spreads the ten thresholds over workers."""
    import time

    import numpy as np

    from ntlink_jax.graphio import EdgeAttr, ScaffoldGraph
    from ntlink_jax.layout import remove_transitive_edges

    rng = np.random.default_rng(3)
    g = ScaffoldGraph()
    n = 1500
    names = [f"v{i}+" for i in range(n)]
    for x in names:
        g.add_node(x, 5000)
    for i in range(n - 1):
        g.add_edge(names[i], names[i + 1], EdgeAttr(d=100, n=5))
    for _ in range(6000):  # local noise
        a = int(rng.integers(0, n))
        b = a + int(rng.integers(-20, 21))
        if 0 <= b < n and a != b:
            g.add_edge(names[a], names[b], EdgeAttr(d=100, n=1))
    for i in range(0, n, 15):  # repeat hubs with long links
        for _ in range(20):
            b = int(rng.integers(0, n))
            if b != i:
                g.add_edge(names[i], names[b], EdgeAttr(d=100, n=1))
    t0 = time.time()
    remove_transitive_edges(g)
    assert time.time() - t0 < 3.0


def test_parallel_n_sweep_matches_serial(tmp_path, monkeypatch):
    """run_n_sweep with worker processes writes byte-identical sweep
    artifacts to the serial path."""
    import filecmp

    import numpy as np

    from ntlink_jax.graphio import EdgeAttr, ScaffoldGraph
    from ntlink_jax.layout import run_n_sweep

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(9)
    g = ScaffoldGraph()
    n = 300
    names = [f"v{i}" for i in range(n)]
    lengths = {}
    for x in names:
        ln = int(rng.integers(2000, 9000))
        lengths[x] = ln
        g.add_node(x + "+", ln)
        g.add_node(x + "-", ln)
    for i in range(n - 1):
        w = int(rng.integers(1, 8))
        g.add_edge(names[i] + "+", names[i + 1] + "+", EdgeAttr(d=100, n=w))
        g.add_edge(names[i + 1] + "-", names[i] + "-", EdgeAttr(d=100, n=w))
    for _ in range(400):
        a, b = rng.integers(0, n, 2)
        if a == b or g.has_edge(names[a] + "+", names[b] + "+"):
            continue
        g.add_edge(names[a] + "+", names[b] + "+", EdgeAttr(d=100, n=1))
        g.add_edge(names[b] + "-", names[a] + "-", EdgeAttr(d=100, n=1))

    serial = run_n_sweep(g, lengths, 1, 5, 1000, 20, "ser", threads=1)
    parallel = run_n_sweep(g, lengths, 1, 5, 1000, 20, "par", threads=4)
    assert len(serial) == len(parallel)
    for a, b in zip(serial, parallel):
        assert filecmp.cmp(a, b, shallow=False)
        assert filecmp.cmp(a + ".sterr", b + ".sterr", shallow=False)


def test_native_transitive_reduce_matches_python():
    """The C kernel (native/graph.c) is bit-compatible with the Python
    sequential walk — same removals on random dense digraphs, including
    the traversal-order-sensitive cases near the hop limit."""
    import numpy as np

    from ntlink_jax.layout import _has_alternate_path, remove_transitive_edges
    from ntlink_jax.native import graph_module

    mod = graph_module()
    assert mod is not None, "native graph module failed to build"

    def python_reduce(g):
        out = g.copy()
        for s, t, _ in list(g.edges()):
            if _has_alternate_path(out, s, t):
                out.remove_edge(s, t)
        return out

    rng = np.random.default_rng(11)
    for trial in range(20):
        n = int(rng.integers(4, 60))
        g = ScaffoldGraph()
        names = [f"v{i}+" for i in range(n)]
        for x in names:
            g.add_node(x, 5000)
        n_edges = int(rng.integers(n, 5 * n))
        seen = set()
        for _ in range(n_edges):
            a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
            if a == b or (a, b) in seen:
                continue
            seen.add((a, b))
            g.add_edge(names[a], names[b], EdgeAttr(d=100, n=1))

        expected = python_reduce(g)
        got = remove_transitive_edges(g)  # uses the native kernel
        ge = {(s, t) for s, t, _ in got.edges()}
        ee = {(s, t) for s, t, _ in expected.edges()}
        assert ge == ee, f"trial {trial}: native != python"


def test_native_transitive_reduce_deep_chain_hop_limit():
    """A bypass longer than MAX_TRANSITIVE_HOPS must NOT remove the direct
    edge; exactly at the limit it must (both engines agree)."""
    from ntlink_jax.layout import MAX_TRANSITIVE_HOPS, remove_transitive_edges

    for extra, expect_removed in ((0, True), (3, False)):
        hops = MAX_TRANSITIVE_HOPS + extra
        g = ScaffoldGraph()
        names = [f"c{i}+" for i in range(hops + 1)]
        for x in names:
            g.add_node(x, 5000)
        for i in range(hops):
            g.add_edge(names[i], names[i + 1], EdgeAttr(d=100, n=5))
        g.add_edge(names[0], names[-1], EdgeAttr(d=100, n=1))  # direct
        out = remove_transitive_edges(g)
        assert out.has_edge(names[0], names[-1]) == (not expect_removed)
