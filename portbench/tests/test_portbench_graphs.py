"""The graph generators: deterministic per seed, and the copies keep
their originals' graphs."""
import numpy as np
import pytest

from harness import cells


def gen(name):
    return cells.load_module(cells.BENCH_DIR / "graphs" / f"{name}.py").generate


@pytest.mark.parametrize("name,params", [
    ("uniform_random", dict(num_nodes=2000, avg_degree=16, structure_seed=0)),
    ("chung_lu", dict(num_nodes=2000, avg_degree=16, exponent=2.2)),
])
def test_deterministic_per_seed_and_symmetric(name, params):
    a, b, c = (gen(name)(s, **params) for s in (11, 11, 12))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    indptr, indices, data = a
    n = params["num_nodes"]
    src = np.repeat(np.arange(n), np.diff(indptr))
    fwd = set(zip(src.tolist(), indices.tolist()))
    assert all((v, u) in fwd for u, v in fwd)
    assert (src != indices).all()
    assert ((data >= 0.5) & (data < 2.0)).all()
    for i in range(n):  # rows sorted, no duplicates
        row = indices[indptr[i]:indptr[i + 1]]
        assert (np.diff(row) > 0).all()


def test_uniform_random_keeps_bench_py_s_graph():
    """The same law as bench.py's build_graph: its edge counts and max
    degrees at these sizes (read from the original at seed 0 and 3) lie
    within the spread of the torch rewrite over structure seeds."""
    for n, edges, maxdeg in ((1000, 15868, 30), (5000, 79832, 33)):
        counts, maxes = [], []
        for structure in range(6):
            indptr, indices, data = gen("uniform_random")(1, n, 16, structure)
            counts.append(indices.size)
            maxes.append(int(np.diff(indptr).max()))
        assert abs(np.mean(counts) - edges) < 0.004 * edges
        assert min(maxes) - 4 <= maxdeg <= max(maxes) + 4
        # no self-loops, and about n * 16 directed entries less the
        # duplicate pairs (m^2 / n^2 of them)
        assert 0.99 * n * 16 < np.mean(counts) < n * 16


def test_uniform_random_same_degrees_for_every_seed():
    """The run's seed relabels the nodes: every seed has the same degree
    sequence (so the same padded row width), in another order."""
    degs = [np.diff(gen("uniform_random")(seed, 3000, 16, 0)[0]) for seed in (1, 2, 3)]
    for d in degs[1:]:
        np.testing.assert_array_equal(np.sort(d), np.sort(degs[0]))
        assert not np.array_equal(d, degs[0])


def test_chung_lu_same_sizes_for_every_seed():
    """The expected degrees are the same quantiles for every seed, so the
    hub count and the largest degree barely move between seeds."""
    stats = []
    for seed in (1, 2, 3):
        indptr, indices, _ = gen("chung_lu")(seed, 20000, 16, 2.2)
        deg = np.diff(indptr)
        stats.append((int(deg.max()), int((deg > 128).sum()), indices.size))
    maxes, hubs, edges = zip(*stats)
    assert max(maxes) < 1.1 * min(maxes)
    assert max(hubs) - min(hubs) <= 0.2 * max(hubs) + 3
    assert max(edges) < 1.02 * min(edges)
