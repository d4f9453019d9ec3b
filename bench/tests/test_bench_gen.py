"""The input generators at small sizes."""
import pytest
import torch

from bench import gen

CPU = torch.device("cpu")


def _acyclic(src, dst, n):
    """Kahn's algorithm: every vertex leaves the queue once."""
    indeg = torch.bincount(dst.long(), minlength=n)
    out = [[] for _ in range(n)]
    for a, b in zip(src.tolist(), dst.tolist()):
        out[a].append(b)
    ready = [v for v in range(n) if indeg[v] == 0]
    seen = 0
    while ready:
        v = ready.pop()
        seen += 1
        for w in out[v]:
            indeg[w] -= 1
            if indeg[w] == 0:
                ready.append(w)
    return seen == n


def test_random_dag_is_m_edges_of_distinct_ends_and_acyclic():
    src, dst = gen.random_dag(torch.Generator().manual_seed(0), 1000, 1006, CPU)
    assert src.shape == dst.shape == (1006,) and src.dtype == torch.int32
    assert bool((src != dst).all()) and int(torch.cat([src, dst]).max()) < 1000
    assert _acyclic(src, dst, 1000)
    # the orientation comes from a random rank, not from the ids
    assert 0.3 < float((src < dst).float().mean()) < 0.7


def test_tree_dag_hangs_each_vertex_under_its_parent():
    src, dst = gen.tree_dag(torch.Generator().manual_seed(0), 100, 99, 8, CPU)
    assert dst.tolist() == list(range(1, 100))
    assert src.tolist() == [(i - 1) // 8 for i in range(1, 100)]
    src, dst = gen.tree_dag(torch.Generator().manual_seed(0), 100, 120, 8, CPU)
    assert src.shape == (120,) and bool((src[99:] < dst[99:]).all())
    with pytest.raises(ValueError):
        gen.tree_dag(torch.Generator(), 100, 98, 8, CPU)


def test_structure_follows_the_configurations_family():
    sparse = dict(family="sparse", n=500, m=503, structure_seed=1)
    tree = dict(family="tree", n=500, m=499, branching=8, structure_seed=1)
    a, b = gen.structure(sparse, CPU), gen.structure(sparse, CPU)
    assert torch.equal(a[0], b[0]) and a[0].shape == (503,)
    assert gen.structure(tree, CPU)[1].tolist() == list(range(1, 500))
    with pytest.raises(ValueError):
        gen.structure(dict(sparse, family="layered"), CPU)


def test_degree_product_order():
    src = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    dst = torch.tensor([1, 2, 3, 3], dtype=torch.int32)
    # scores (out + 1)(in + 1): 3, 4, 4, 3
    assert gen.degree_product_order(src, dst, 4, 4).tolist() == [1, 2, 0, 3]


@pytest.mark.parametrize("family", ["sparse", "tree"])
def test_relabeled_graphs_are_one_structure_numbered_apart(family):
    config = dict(family=family, n=2000, m=2000 if family == "sparse" else 1999,
                  branching=8, structure_seed=0)
    a = gen.relabeled_graph(config, 2**31 + 11, 16, CPU)
    b = gen.relabeled_graph(config, 2**31 + 12, 16, CPU)
    assert not torch.equal(a[0], b[0])
    # the same edges under the two numberings: map a's ids onto b's
    perm = torch.full((2000,), -1, dtype=torch.int64)
    perm[a[0].long()] = b[0].long()
    perm[a[1].long()] = b[1].long()
    assert torch.equal(perm[a[0].long()], b[0].long())
    assert torch.equal(perm[a[1].long()], b[1].long())
    assert torch.equal(perm[a[2]], b[2])
