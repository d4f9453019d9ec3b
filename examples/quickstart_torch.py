"""Quickstart on the PyTorch/CUDA port: build a reachability oracle, answer
queries, verify vs BFS, then serve a batch through the engine on the card.

  PYTHONPATH=src python examples/quickstart_torch.py              # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The counterpart of ``examples/quickstart.py``: Distribution-Labeling,
Hierarchical-Labeling and ``OnlineBFS`` agree on every query, and the
engine's ``auto`` backend (K1's batch form on the card) answers them.
"""
import argparse

import numpy as np

from repro_torch.core import distribution_labeling, hierarchical_labeling
from repro_torch.core.baselines import OnlineBFS
from repro_torch.device import resolve_device
from repro_torch.graph.generators import paper_dataset_analogue


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine's labels live (cuda|cpu)")
    device = resolve_device(ap.parse_args(argv).device)

    # a paper-benchmark-sized DAG (amaze analogue: n=3710, m=3600)
    g = paper_dataset_analogue("amaze")
    print(f"graph: n={g.n} m={g.m}")

    dl = distribution_labeling(g, device=device)
    print(f"Distribution-Labeling: {dl.total_label_size} label ints "
          f"({dl.total_label_size / g.n:.1f}/vertex)")

    hl = hierarchical_labeling(g, core_max=512, device=device)
    print(f"Hierarchical-Labeling: {hl.total_label_size} label ints "
          f"({hl.total_label_size / g.n:.1f}/vertex)")

    bfs = OnlineBFS(g)
    rng = np.random.default_rng(0)
    queries = rng.integers(0, g.n, size=(500, 2))
    agree = sum(
        dl.query(int(u), int(v)) == bfs.query(int(u), int(v)) == hl.query(int(u), int(v))
        for u, v in queries
    )
    print(f"oracle vs BFS agreement: {agree}/500")
    if agree != 500:
        raise SystemExit(f"only {agree} of 500 queries agree")

    # batched serving through the engine (prefilters + bucketed batching)
    from repro_torch.serve import QueryEngine
    from repro_torch.serve.prefilter import topo_levels

    engine = QueryEngine(dl, backend="auto", level=topo_levels(g), device=device)
    pred = engine.query_batch(queries.astype(np.int32))
    stats = engine.last_stats
    print(f"engine[{stats['backend']}] on {device}: {int(pred.sum())} reachable of "
          f"{len(queries)} ({stats['n_prefiltered']} decided by prefilters)")


if __name__ == "__main__":
    main()
