"""Dynamic oracle walkthrough on the PyTorch/CUDA port: edge updates,
epochs, repair vs rebuild.

  PYTHONPATH=src python examples/dynamic_demo_torch.py              # on the card
  PYTHONPATH=src python examples/dynamic_demo_torch.py --device cpu

Builds a DynamicOracle on a citation-style DAG, then walks the API:

  1. apply an update batch (inserts + deletes) — labels repair in place,
  2. publish an epoch — queries before/after see different worlds,
  3. pin an old epoch — answers stay frozen while the graph moves on,
  4. close a cycle — the SCC merge collapses condensation vertices and the
     staleness machinery routes the next publish through a full rebuild,
  5. replay an interleaved trace and print the repair-vs-rebuild economics.

The counterpart of ``examples/dynamic_demo.py``.  The current epoch serves
through the engine (K1's batch form on the card), a pinned one through K1's
tier form; the demo exits nonzero when a pinned epoch's answers differ from
its host merge.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.build.engine import build_distribution_labels
from repro_torch.device import resolve_device
from repro_torch.dynamic import DynamicOracle, UpdateBatch, generate_trace, replay
from repro_torch.graph.generators import paper_dataset_analogue


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine and the pinned epochs serve (cuda|cpu)")
    device = resolve_device(ap.parse_args(argv).device)
    g = paper_dataset_analogue("citeseer", scale=0.02)
    print(f"graph: citeseer analogue, n={g.n} m={g.m}")
    dyn = DynamicOracle(g, device=device)
    print(f"epoch {dyn.epoch}: label ints = {dyn.total_label_size}")

    # ---- 1+2: update batch -> repair -> publish -------------------------
    rng = np.random.default_rng(0)
    # a DAG-preserving insert that actually creates reachability: orient
    # along the topological levels and prefer a not-yet-reachable pair
    lvl = dyn.level
    cand = rng.integers(0, g.n, size=(256, 2))
    pairs = [(int(a), int(b)) for a, b in cand
             if lvl[dyn.delta.comp[a]] < lvl[dyn.delta.comp[b]]]
    ins = next((p for p in pairs if not dyn.query(*p)), pairs[0])
    src, dst = g.edges()
    dele = (int(src[0]), int(dst[0]))
    before = dyn.query(*ins)
    stats = dyn.apply(UpdateBatch.of(inserts=[ins], deletes=[dele]))
    e1 = dyn.publish()
    print(f"applied 1 insert + 1 delete -> epoch {e1} "
          f"(repaired inserts={stats.repaired_inserts}, "
          f"deletes={stats.repaired_deletes}, "
          f"label appends={stats.label_appends}, drops={stats.label_drops})")
    print(f"query{ins}: {before} before, {dyn.query(*ins)} after")

    # ---- 3: epoch pinning ----------------------------------------------
    pinned = dyn.query(*ins, epoch=e1 - 1)
    print(f"pinned to epoch {e1 - 1}: query{ins} still {pinned}")

    # ---- 4: a structural event (SCC merge) ------------------------------
    # inserting the reverse of a reachable pair closes a cycle
    u, v = ins
    dyn.apply(UpdateBatch.of(inserts=[(v, u)]))
    dyn.publish()  # staleness machinery: merge -> compacting rebuild
    print(f"inserted ({v}, {u}) closing a cycle: same-SCC now "
          f"{dyn.query(v, u)} and {dyn.query(u, v)}; "
          f"rebuilds so far = {dyn.rebuild_count - 1}")

    # ---- 5: interleaved trace + the repair-vs-rebuild economics ---------
    trace = generate_trace(g, rounds=5, updates_per_round=50,
                           queries_per_round=1000, dag_preserving=True, seed=1)
    rstats = replay(dyn, trace)
    t0 = time.perf_counter()
    build_distribution_labels(dyn.delta.dag_csr(), device=device)
    t_rebuild = time.perf_counter() - t0
    print(f"replayed {rstats.n_updates} updates / {rstats.n_queries} queries: "
          f"{rstats.updates_per_sec:,.0f} updates/sec repaired "
          f"(vs {50 / t_rebuild:,.0f} rebuilding per 50-update batch), "
          f"query p50 {rstats.query_pctile(0.5) * 1e3:.2f} ms/batch")
    print(f"epochs published: {rstats.epochs}; pinnable: {dyn.epochs}")
    # every pinned epoch on the device path (K1's tier form on the card)
    # against its own host merge
    q = rng.integers(0, g.n, size=(4096, 2)).astype(np.int32)
    for e in dyn.epochs:
        snap = dyn.snapshot(e)
        if not np.array_equal(snap.query_batch(q), snap.query_batch(q, device=False)):
            raise SystemExit(f"epoch {e}: the device path differs from the host merge")
    print(f"pinned epochs {dyn.epochs} on {device}: device path = host merge "
          f"on {q.shape[0]} queries each")


if __name__ == "__main__":
    main()
