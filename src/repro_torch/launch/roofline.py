"""Roofline report generator: experiments/dryrun_torch/*.json -> markdown
table, the port of ``repro.launch.roofline`` against the H100's figures
(``launch.trace_analysis``: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink
4 at 450 GB/s a direction).

  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single] \
      [--variant tp1] [--out experiments/roofline_torch.md]

Per (arch x shape): the three roofline terms (seconds/step/card), dominant
bottleneck, MODEL_FLOPS (6ND-style useful work), the MODEL/trace ratio, and
a one-line lever for the dominant term.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict

from repro_torch.launch.trace_analysis import HBM_BW, LINK_BW, PEAK_FLOPS


def model_flops_of(rec: Dict) -> float:
    """Whole-step useful FLOPs. LM cells carry it (6ND + attention);
    other families get family-level estimates from meta dims."""
    if rec.get("model_flops"):
        return float(rec["model_flops"])
    meta = rec.get("meta", {})
    arch, kind = rec["arch"], rec.get("kind")
    mult = 3 if kind == "train" else 1  # train = 3x forward
    if arch == "gcn-cora":
        n, m, d = meta["n_nodes"], meta["n_edges"], meta["d_feat"]
        return mult * 2 * (n * d * 16 + m * 16 + n * 16 * 7)
    if arch == "gatedgcn":
        n, m, d = meta["n_nodes"], meta["n_edges"], 70
        return mult * 16 * 2 * (5 * n * d * d + 3 * m * d)
    if arch == "schnet":
        n, m = meta["n_nodes"], meta["n_edges"]
        d, rbf = 64, 300
        return mult * 3 * 2 * (m * (rbf * d + 2 * d * d) + 2 * n * d * d)
    if arch == "graphcast":
        n_m, m_mesh = meta["n_mesh"], meta["m_mesh"]
        n_g = meta["n_grid"]
        d = 512
        proc = 16 * 2 * (m_mesh * (2 * d * d + d * d) + n_m * 2 * d * d)
        encdec = 2 * (4 * n_g * (2 * d * d)) + 2 * n_g * 227 * d
        return mult * (proc + encdec)
    if arch == "xdeepfm":
        B = meta.get("batch", meta.get("n_candidates", 1))
        m, D = 39, 10
        cin = 0
        h_prev = m
        for h in (200, 200, 200):
            cin += B * (h_prev * m * D + h * h_prev * m * D) * 2
            h_prev = h
        mlp = B * (m * D * 400 + 400 * 400 + 400) * 2
        return mult * (cin + mlp)
    if arch == "reachability-oracle":
        if rec["shape"].startswith("serve"):
            B, L = meta["queries"], meta["l_max"]
            return B * L * L  # compare ops
        n, m, L = meta["n"], meta["m"], meta["l_max"]
        return 64 * (n * L + m)  # per BFS level: prune lookups + edge sweep
    return 0.0


LEVERS = {
    ("lm", "compute"): "already tensor-core-bound: raise per-card utilization via larger "
                       "microbatch / fused qkv; beyond that it is roofline",
    ("lm", "memory"): "cut HBM traffic: fuse attention chunks (flash kernel), "
                      "raise arithmetic intensity with bigger microbatches, "
                      "bf16 optimizer reads",
    ("lm", "collective"): "overlap TP all-reduces with compute (async collective "
                          "scheduling), shrink DP grad payload via int8 compression",
    ("gnn", "compute"): "tensor-core-align feature dims (pad to 64), batch small matmuls",
    ("gnn", "memory"): "edge-gather traffic dominates: degree-sort + ELL tiles "
                       "(ell_spmm kernel), cache hub features in shared memory",
    ("gnn", "collective"): "vertex-cut partitioning to localize segment-sums; "
                           "reduce-scatter instead of all-reduce on node grads",
    ("recsys", "memory"): "embedding row gathers dominate: row-shard tables + "
                          "batch dedup of repeated ids",
    ("recsys", "compute"): "CIN outer-product einsum is the hotspot: reorder to "
                           "contract D first, fuse ReLU",
    ("recsys", "collective"): "table gathers cross shards: hash-shard by field "
                              "to localize lookups",
    ("oracle", "memory"): "label rows stream once per query batch: sort queries "
                          "by source vertex to reuse gathered rows",
    ("oracle", "compute"): "L^2 compare is CUDA-core-bound: bit-pack labels "
                           "(32x fewer lane ops, bitset_mm-style)",
    ("oracle", "collective"): "query->label-shard routing: sort queries by shard "
                              "to turn gathers into all-to-all",
}

FAMILY = {
    "h2o-danube-1.8b": "lm", "granite-3-2b": "lm", "deepseek-7b": "lm",
    "deepseek-v2-lite-16b": "lm", "granite-moe-1b-a400m": "lm",
    "gcn-cora": "gnn", "graphcast": "gnn", "schnet": "gnn", "gatedgcn": "gnn",
    "xdeepfm": "recsys", "reachability-oracle": "oracle",
}


def build_report(dryrun_dir: str, mesh: str, variant_suffix: str = "") -> str:
    """The table of ``dryrun_dir``'s records of ``mesh`` (``variant_suffix``
    "__tp1" for a variant's)."""
    rows = []
    pattern = os.path.join(dryrun_dir, f"*__{mesh}{variant_suffix}.json")
    for path in sorted(glob.glob(pattern)):
        base = os.path.basename(path)
        if variant_suffix == "" and base.count("__") != 2:
            continue  # skip variant files in the baseline table
        with open(path) as f:
            rec = json.load(f)
        if rec["status"] == "skipped":
            rows.append((rec["arch"], rec["shape"], None, rec["skip_reason"]))
            continue
        if rec["status"] != "ok":
            rows.append((rec["arch"], rec["shape"], None, "ERROR: " + rec["error"][:80]))
            continue
        r = rec["roofline"]
        n_chips = rec["n_chips"]
        mf = model_flops_of(rec)
        flops_dev = r["compute_s"] * PEAK_FLOPS
        ratio = (mf / n_chips) / flops_dev if flops_dev > 0 else float("nan")
        fam = FAMILY[rec["arch"]]
        lever = LEVERS.get((fam, r["dominant"]), "")
        rows.append((rec["arch"], rec["shape"], dict(
            comp=r["compute_s"], mem=r["memory_s"], coll=r["collective_s"],
            dom=r["dominant"], bound=r["bound_s"], source=r.get("source", "trace"),
            model_flops=mf, ratio=ratio, lever=lever,
            frac=r["compute_s"] / r["bound_s"] if r["bound_s"] > 0 else 0.0,
        ), None))

    lines = [
        f"### Roofline — {mesh}{variant_suffix} mesh (per-card seconds/step; H100 SXM: "
        f"{PEAK_FLOPS/1e12:.0f} TF bf16, {HBM_BW/1e9:.0f} GB/s HBM3, "
        f"{LINK_BW/1e9:.0f} GB/s NVLink a direction)",
        "",
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "roofline frac (comp/bound) | MODEL_FLOPS | MODEL/trace | src | lever for dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape, d, note in rows:
        if d is None:
            lines.append(f"| {arch} | {shape} | — | — | — | skipped | — | — | — | — | {note} |")
            continue
        lines.append(
            f"| {arch} | {shape} | {d['comp']:.2e} | {d['mem']:.2e} | {d['coll']:.2e} "
            f"| **{d['dom']}** | {d['frac']:.2f} | {d['model_flops']:.2e} "
            f"| {d['ratio']:.2f} | {d['source'][:8]} | {d['lever']} |"
        )
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="experiments/roofline_torch.md")
    args = ap.parse_args()
    suffix = "" if args.variant == "baseline" else f"__{args.variant}"
    report = build_report(args.dryrun_dir, args.mesh, suffix)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(report + "\n")
    print(report)


if __name__ == "__main__":
    main()
