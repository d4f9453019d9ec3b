"""Print a graph's host-build counts from the JAX package and from the port.

    PYTHONPATH=src python tools/build_counts.py [--dataset citeseer] \
        [--scale 0.15] [--impl auto speculative wave] [--package both] \
        [--method distribution|hierarchical]

Builds labels of ``condense_to_dag(paper_dataset_analogue(dataset, scale))``
with ``repro`` (the JAX package), with ``repro_torch`` (the port) or with
both, on the host, and prints one JSON line per package (and impl), with
the build's seconds on this host's clock and, with both packages, whether
their labels and counts are equal.  Exits 1 when both packages ran and
differ; the JAX package runs wherever JAX is installed, the port anywhere.

``--method distribution`` (the default) runs ``build_distribution_labels(g,
impl=...)`` for each ``--impl`` and prints the impl it resolved to,
``n_waves`` and the integer speculation counts (``build_stats
["speculation"]`` without its ``*_seconds``) and the sha256 of the five
label fields (``L_out``, ``L_in``, ``out_len``, ``in_len``, ``hop_rank``):
the counts ``chip_smoke.py`` holds the port to at citeseer@1.0 and @0.5
(``SPEC_BOUNDARIES``, ``WAVE_BOUNDARIES``, ``SPEC_COUNTS``, ``DL_SHA256``;
the latter also at @0.25 and @0.02).

``--method hierarchical`` runs ``hierarchical_labeling(g)`` and prints the
level sizes of ``decompose``, the label matrices' shapes, the label ints
(``out_len.sum() + in_len.sum()``) and the sha256 of ``L_out.tobytes() +
L_in.tobytes()``: the counts ``chip_smoke.py`` holds the port to at
citeseer@1.0 (``HL_LEVEL_SIZES``, ``HL_SHAPE``, ``HL_LABEL_INTS``,
``HL_SHA256``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")


def labels_sha256(o) -> str:
    """sha256 of a Distribution-Labeling oracle's five label fields, in
    ``FIELDS`` order (``chip_smoke.py``'s ``DL_SHA256``)."""
    return hashlib.sha256(b"".join(getattr(o, f).tobytes() for f in FIELDS)).hexdigest()


def _counts(o) -> dict:
    s = o.build_stats
    spec = s.get("speculation")
    return {"impl": s["impl"], "n_waves": s["n_waves"],
            "speculation": None if spec is None else
            {k: v for k, v in spec.items() if not k.endswith("_seconds")},
            "sha256": labels_sha256(o)}


def _hl_counts(o, level_sizes) -> dict:
    return {"level_sizes": [int(n) for n in level_sizes],
            "shape_out": list(o.L_out.shape), "shape_in": list(o.L_in.shape),
            "label_ints": int(o.out_len.sum() + o.in_len.sum()),
            "sha256": hashlib.sha256(o.L_out.tobytes() + o.L_in.tobytes()).hexdigest()}


def _builders(method: str, pkg: str):
    """(build(graph, impl) -> oracle, counts(oracle, graph) -> dict) of one package."""
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    if method == "hierarchical":
        if pkg == "repro":
            import repro.core.hierarchy as hierarchy
        else:
            import repro_torch.core.hierarchy as hierarchy
        return (lambda g, impl: hierarchy.hierarchical_labeling(g, **kw),
                lambda o, g: _hl_counts(o, [lv.n for lv in hierarchy.decompose(g).levels]))
    if pkg == "repro":
        import repro.build.engine as engine
    else:
        import repro_torch.build.engine as engine
    # device="cpu": "auto" then resolves as on a host without a card
    return (lambda g, impl: engine.build_distribution_labels(g, impl=impl, **kw),
            lambda o, g: _counts(o))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="citeseer")
    ap.add_argument("--scale", type=float, default=0.15)
    ap.add_argument("--impl", nargs="+", default=["auto", "speculative", "wave"],
                    help="the build impls of --method distribution")
    ap.add_argument("--package", choices=("repro", "repro_torch", "both"), default="both")
    ap.add_argument("--method", choices=("distribution", "hierarchical"),
                    default="distribution")
    args = ap.parse_args(argv)

    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.scc import condense_to_dag

    g = condense_to_dag(paper_dataset_analogue(args.dataset, args.scale))[0]
    graphs = {}
    if args.package in ("repro", "both"):
        import repro.graph.csr

        graphs["repro"] = repro.graph.csr.CSRGraph(g.indptr.copy(), g.indices.copy())
    if args.package in ("repro_torch", "both"):
        graphs["repro_torch"] = g
    engines = {pkg: _builders(args.method, pkg) for pkg in graphs}
    ok = True
    for impl in (args.impl if args.method == "distribution" else [None]):
        built, counts = {}, {}
        for pkg, (build, count) in engines.items():
            t0 = time.perf_counter()
            built[pkg] = build(graphs[pkg], impl)
            seconds = time.perf_counter() - t0
            counts[pkg] = count(built[pkg], graphs[pkg])
            rec = dict(package=pkg, dataset=args.dataset, scale=args.scale, n=g.n,
                       method=args.method, seconds=seconds, **counts[pkg])
            if impl is not None:
                rec["asked"] = impl
            if len(built) == 2:
                a, b = built.values()
                rec["equal_to_repro"] = (counts["repro"] == counts["repro_torch"] and all(
                    getattr(a, f) is None and getattr(b, f) is None
                    or getattr(a, f).tobytes() == getattr(b, f).tobytes() for f in FIELDS))
                ok &= rec["equal_to_repro"]
            print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
