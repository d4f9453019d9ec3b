"""Oracle x GNN on the port: hop labels as reachability features for a GCN
node classifier on a DAG, the counterpart of ``examples/gnn_reachability.py``.

The oracle is built once on the workload graph
(``repro_torch.core.build_oracle``); each vertex's label lengths and top hop
become extra node features, and GCN (K5 and its transposed launch on the
card, their plain versions with ``--device cpu``) trains on them with AdamW.

  PYTHONPATH=src python examples/gnn_reachability_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import build_oracle
from repro_torch.data.synth import graph_batch_from_csr
from repro_torch.graph.generators import layered_dag
from repro_torch.graph.reach import bfs_levels
from repro_torch.models.gnn import gcn
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import tree_leaves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    g = layered_dag(600, 2.5, seed=0)
    co = build_oracle(g, device=args.device)
    stats = co.engine.stats()
    print(f"graph n={g.n} m={g.m}; oracle {co.total_label_size} ints")
    print(f"engine stats: epoch={stats['epoch']} backend={stats['backend']} "
          f"tier widths={stats['widths']} quarantined rows={stats['n_quarantined']}")
    oracle, comp = co.oracle, co.comp

    d_base = 16
    batch = graph_batch_from_csr(g, d_base, seed=0, n_classes=4, device=args.device)
    # the reachability feature channel a vertex of the graph (labels live in
    # the condensation's ids): [out_len, in_len, min_out_hop_rank]
    reach_feats = np.stack(
        [
            oracle.out_len[comp] / max(oracle.out_len.max(), 1),
            oracle.in_len[comp] / max(oracle.in_len.max(), 1),
            oracle.L_out[comp, 0] / g.n,
        ],
        axis=1,
    ).astype(np.float32)
    x = torch.cat([batch.x, torch.from_numpy(reach_feats).to(batch.x.device)], dim=1)
    # labels correlated with reachability depth (so the channel helps)
    lv = bfs_levels(g, int(np.argmax(oracle.out_len[comp])))
    y = torch.from_numpy(np.clip(lv, 0, 3).astype(np.int32)).to(batch.x.device)
    batch = batch._replace(x=x, y=y)

    cfg = gcn.GCNConfig(n_layers=2, d_in=d_base + 3, d_hidden=32, n_classes=4)
    params = gcn.init_params(cfg, torch.Generator(device=args.device).manual_seed(0),
                             device=args.device)
    opt = adamw_init(params)
    ell = gcn.graph_ell(batch)   # built once: both of K5's layouts

    for s in range(args.steps):
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = gcn.loss_fn(cfg, params, batch, ell)
        grads = torch.autograd.grad(loss, leaves)
        params, opt, _ = adamw_update(grads, opt, params, 5e-3)
        if s % 20 == 0 or s == args.steps - 1:
            with torch.no_grad():
                logits = gcn.forward(cfg, params, batch, ell)
            acc = float((logits.argmax(-1) == batch.y.long()).float().mean())
            print(f"step {s:3d} loss {float(loss):.4f} acc {acc:.3f}")


if __name__ == "__main__":
    main()
