"""Print a graph's host-build counts from the JAX package and from the port.

    PYTHONPATH=src python tools/build_counts.py [--dataset citeseer] \
        [--scale 0.15] [--impl auto speculative wave] [--package both]

Builds ``condense_to_dag(paper_dataset_analogue(dataset, scale))`` with
``build_distribution_labels(g, impl=...)`` of ``repro`` (the JAX package),
of ``repro_torch`` (the port) or of both, on the host, and prints one JSON
line per package and impl: the impl it resolved to, ``n_waves``, the
integer speculation counts (``build_stats["speculation"]`` without its
``*_seconds``), the build's seconds on this host's clock and, with both
packages, whether their labels and counts are equal.  These are the counts
``chip_smoke.py`` holds the port to at citeseer@1.0 (``SPEC_BOUNDARIES``,
``WAVE_BOUNDARIES``, ``SPEC_COUNTS``); the JAX package runs wherever JAX is
installed, the port anywhere.  Exits 1 when both packages ran and differ.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")


def _counts(o) -> dict:
    s = o.build_stats
    spec = s.get("speculation")
    return {"impl": s["impl"], "n_waves": s["n_waves"],
            "speculation": None if spec is None else
            {k: v for k, v in spec.items() if not k.endswith("_seconds")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="citeseer")
    ap.add_argument("--scale", type=float, default=0.15)
    ap.add_argument("--impl", nargs="+", default=["auto", "speculative", "wave"])
    ap.add_argument("--package", choices=("repro", "repro_torch", "both"), default="both")
    args = ap.parse_args(argv)

    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.scc import condense_to_dag

    g = condense_to_dag(paper_dataset_analogue(args.dataset, args.scale))[0]
    engines = {}
    if args.package in ("repro", "both"):
        import repro.build.engine
        import repro.graph.csr

        engines["repro"] = (repro.build.engine.build_distribution_labels,
                            repro.graph.csr.CSRGraph(g.indptr.copy(), g.indices.copy()))
    if args.package in ("repro_torch", "both"):
        import repro_torch.build.engine

        # device="cpu": "auto" then resolves as on a host without a card
        engines["repro_torch"] = (repro_torch.build.engine.build_distribution_labels, g)
    ok = True
    for impl in args.impl:
        built = {}
        for pkg, (build, graph) in engines.items():
            kw = {"device": "cpu"} if pkg == "repro_torch" else {}
            t0 = time.perf_counter()
            built[pkg] = build(graph, impl=impl, **kw)
            rec = dict(package=pkg, dataset=args.dataset, scale=args.scale, n=g.n,
                       asked=impl, seconds=time.perf_counter() - t0, **_counts(built[pkg]))
            if len(built) == 2:
                a, b = built.values()
                rec["equal_to_repro"] = (_counts(a) == _counts(b) and all(
                    getattr(a, f).tobytes() == getattr(b, f).tobytes() for f in FIELDS))
                ok &= rec["equal_to_repro"]
            print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
