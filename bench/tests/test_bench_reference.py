"""The plain reference against hand-made cases and against the transitive
closure."""
import torch

from bench import gen, reference

CPU = torch.device("cpu")
X = gen.INVALID


def test_reach_stops_at_pruned_vertices_and_at_max_steps():
    # 0 -> 1 -> 2 -> 3, 0 -> 4
    src = torch.tensor([0, 1, 2, 0])
    dst = torch.tensor([1, 2, 3, 4])
    g = reference.csr(src, dst, 5)
    none = torch.zeros(5, dtype=torch.bool)
    assert reference.reach(g, 0, none, 64).tolist() == [True] * 5
    assert reference.reach(g, 0, none, 2).tolist() == [True, True, True, False, True]
    pruned = torch.tensor([False, True, False, False, False])
    assert reference.reach(g, 0, pruned, 64).tolist() == [True, True, False, False, True]
    assert reference.reach(g, 0, none, 64, short=True).tolist() == [
        True, True, True, False, True]


def test_distribute_by_hand():
    # a chain 0 -> 1 -> 2, order 1, 0, 2
    src, dst = torch.tensor([0, 1], dtype=torch.int32), torch.tensor([1, 2], dtype=torch.int32)
    s = reference.distribute(src, dst, torch.tensor([1, 0, 2]), 3, 4, 64)
    # vertex 1: L_out gets 1 at 0, 1; L_in gets 1 at 1, 2.  Vertex 0: its
    # L_in(0) is empty, so 0 gains 0 in L_out; forward, 1 and 2 already hold 1,
    # which L_out(0) holds: pruned, so only 0 gains 0 in L_in.  Vertex 2: L_in(2)
    # = {1}; ancestors 1 and 0 hold 1 in L_out: pruned; 2 gains 2 in L_out; L_out(2)
    # = {2}, L_in(2) lacks 2: 2 gains 2 in L_in
    assert s["L_out"].tolist() == [[1, 0, X, X], [1, X, X, X], [2, X, X, X]]
    assert s["L_in"].tolist() == [[0, X, X, X], [1, X, X, X], [1, 2, X, X]]
    assert s["out_len"].tolist() == [2, 1, 1] and s["in_len"].tolist() == [1, 1, 2]
    assert not bool(s["overflow"])


def test_distribute_over_every_vertex_answers_reachability_exactly():
    """Distribution-Labeling over the whole order is a 2-hop cover: the
    labels answer every pair as the transitive closure does."""
    n = 60
    src, dst = gen.random_dag(torch.Generator().manual_seed(5), n, 150, CPU)
    order = gen.degree_product_order(src, dst, n, n)
    s = reference.distribute(src, dst, order, n, n, n)
    reach = torch.eye(n, dtype=torch.bool)
    for a, b in zip(src.tolist(), dst.tolist()):
        reach[a, b] = True
    for k in range(n):
        reach |= reach[:, k:k + 1] & reach[k:k + 1, :]
    assert torch.equal(_answers(s), reach)
    # and the control, one BFS level short, is no cover
    short = reference.distribute(src, dst, order, n, n, n, short=True)
    assert not torch.equal(_answers(short), reach)


def _answers(s):
    """bool[n, n]: u == v or L_out(u) and L_in(v) share a hop."""
    n = s["L_out"].shape[0]
    outs = [set(r[:k]) for r, k in zip(s["L_out"].tolist(), s["out_len"].tolist())]
    ins = [set(r[:k]) for r, k in zip(s["L_in"].tolist(), s["in_len"].tolist())]
    return torch.tensor([[u == v or bool(outs[u] & ins[v]) for v in range(n)]
                         for u in range(n)])


def test_distribute_marks_overflow_and_writes_the_last_column():
    # a star: 0 -> 1, 2, 3; every vertex of the order labels 0's L_out, the
    # third and fourth into its last column
    src = torch.tensor([0, 0, 0], dtype=torch.int32)
    dst = torch.tensor([1, 2, 3], dtype=torch.int32)
    s = reference.distribute(src, dst, torch.tensor([1, 2, 3, 0]), 4, 2, 64)
    assert bool(s["overflow"])
    assert s["L_out"][0].tolist() == [1, 0] and int(s["out_len"][0]) == 4
