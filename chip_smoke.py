"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (``nvcc``).  Phases, each raising on failure:

  1. device: the card's name and power limit (from ``nvidia-smi``);
  2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``;
  3. each kernel against its plain PyTorch version on the card (exact
     equality: verdicts are booleans) over edge shapes and widths;
  4. the main path: the citeseer analogue at full size (n = 693,947) through
     ``repro_torch.core.api.build_oracle(g, device="cuda").serve(q)`` with
     ``backend="auto"`` (which must resolve to the kernel), about 1M queries
     mixing uniform and reachable pairs; verdicts held against the host
     merge on every query and against BFS truth on a sample; the kernels'
     launch counts read around exactly this run;
  5. timing of each kernel and its plain version with CUDA events at the
     serving shape, and the kernels JSON line;
  6. where a serving batch spends its time: the device's busy share over a
     window of the main path (torch.profiler) and the engine's spans;
  7. the serve driver (``repro_torch.launch.serve``) on a small graph, a
     second path on the card: its own launch counts, every degradation
     counter 0.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository beside it, the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks.  HBM bytes/s: NVIDIA's data sheet.  The data sheet gives
# no INT32 rate; its 67 TFLOP/s float32 rate counts an FMA as two operations
# on 128 float32 lanes per SM, and a Hopper SM has 64 INT32 lanes (NVIDIA
# H100 Tensor Core GPU Architecture whitepaper), so one int32 compare per
# lane per clock is 67e12 / 2 / 2
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4

MAIN_DATASET = "citeseer"
MAIN_SCALE = 1.0
MAIN_QUERIES = 1 << 20
BATCH = 4096
BFS_SAMPLE = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def record(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ phase 1


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    record({"phase": "device", "name": name, "count": torch.cuda.device_count(),
            "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda})
    return name, smi.splitlines()[0]


# ------------------------------------------------------------------ phase 2


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    info = {name: build.build(name) for name in build.SIGNATURES}
    seconds = time.perf_counter() - t0
    for name, rec in info.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[{name}] {line.strip()}")
    record({"phase": "build", "seconds": seconds,
            "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"]}
                        for k, v in info.items()}})


# ------------------------------------------------------------------ phase 3


def _random_rows(rng, n, width, lo_valid, hi_valid, value_range, sorted_prefix):
    """int32[n, width] label rows: a valid prefix of random length, INVALID
    after it (the oracle's layout) or INVALID scattered anywhere."""
    mat = rng.integers(0, value_range, size=(n, width)).astype(np.int32)
    if sorted_prefix:
        mat.sort(axis=1)
        lens = rng.integers(lo_valid, hi_valid + 1, size=n)
        mat[np.arange(width)[None, :] >= lens[:, None]] = -1
    else:
        mat[rng.random((n, width)) < 0.3] = -1
    return mat


def phase_kernel_vs_plain(device) -> dict:
    """Every kernel against its plain version on the card, exact equality.
    Returns {kernel name: number of cases checked}."""
    import torch

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(11)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731

    def identity(B):   # queries (i, i): row i of L_out against row i of L_in
        return t(np.repeat(np.arange(B, dtype=np.int32)[:, None], 2, axis=1))

    cases = 0
    # the shapes of the JAX package's kernel sweep, rows taken as they lie
    for B, La, Lb in [(7, 8, 8), (64, 24, 16), (300, 64, 48), (1, 128, 128)]:
        a = _random_rows(rng, B, La, 0, La, 60, sorted_prefix=False)
        b = _random_rows(rng, B, Lb, 0, Lb, 60, sorted_prefix=False)
        got = ops.tier_intersect(t(a), t(b), identity(B), max(La, Lb))
        torch.cuda.synchronize()
        exp = ref.label_intersect_ref(t(a), t(b))
        check(torch.equal(got, exp), f"label_intersect B={B} La={La} Lb={Lb}")
        cases += 1
    # all-INVALID rows
    allpad = np.full((16, 8), -1, np.int32)
    got = ops.tier_intersect(t(allpad), t(allpad), identity(16), 8)
    torch.cuda.synchronize()
    check(not bool(got.any()), "all-INVALID rows must never intersect")
    cases += 1
    # the fused gather: resident matrices shaped like the main path's
    # (L_out 16 wide, L_in 8 wide) and a wide pair, every tier width,
    # B = 1 and B not a multiple of any block size, ids up to n - 1
    n = 5000
    for Lo, Li in [(16, 8), (128, 40)]:
        for sorted_prefix in (True, False):
            L_out = t(_random_rows(rng, n, Lo, 0, Lo, 400, sorted_prefix))
            L_in = t(_random_rows(rng, n, Li, 0, Li, 400, sorted_prefix))
            for B in (1, 4099):
                q = rng.integers(0, n, size=(B, 2)).astype(np.int32)
                q[-1] = (n - 1, n - 1)
                for width in (8, 16, 24, 128):
                    got = ops.tier_intersect(L_out, L_in, t(q), width)
                    torch.cuda.synchronize()
                    exp = ref.tier_intersect_ref(L_out, L_in, t(q), width)
                    check(torch.equal(got, exp),
                          f"tier_intersect Lo={Lo} Li={Li} B={B} width={width} "
                          f"sorted={sorted_prefix}")
                    check(B == 1 or bool(exp.any()) and not bool(exp.all()),
                          "the check needs hits and misses")
                    cases += 1
    record({"phase": "kernel_vs_plain", "label_intersect_cases": cases,
            "matches_plain": True})
    return {"label_intersect": cases}


# ------------------------------------------------------------------ phase 4


def make_traffic(g, co, n_queries: int, seed: int = 0) -> np.ndarray:
    """int32[n_queries, 2] original-id queries: half uniform pairs, a quarter
    reachable pairs from random sources, an eighth reachable pairs from
    sources with long L_out rows (so the widest tier sees hits) and an eighth
    uniform targets of those sources (so it sees misses)."""
    from repro_torch.graph.reach import reachable_set

    rng = np.random.default_rng(seed)
    n = g.n
    out_deg = g.out_degree()
    long_src = np.flatnonzero(co.oracle.out_len[co.comp] > co.engine.widths[0])
    check(long_src.size > 0, "no vertex has a label wider than the first tier")

    def reach_pool(sources):
        us, vs = [], []
        for u in sources:
            cone = np.flatnonzero(reachable_set(g, int(u)))
            us.append(np.full(cone.size, u, np.int64))
            vs.append(cone)
        return np.concatenate(us), np.concatenate(vs)

    pool_any = reach_pool(rng.choice(np.flatnonzero(out_deg > 0), 20000))
    pool_long = reach_pool(rng.choice(long_src, min(long_src.size, 2000), replace=False))
    k_uni, k_any, k_long = n_queries // 2, n_queries // 4, n_queries // 8
    k_long_miss = n_queries - k_uni - k_any - k_long
    pick_any = rng.integers(0, pool_any[0].size, k_any)
    pick_long = rng.integers(0, pool_long[0].size, k_long)
    q = np.concatenate([
        rng.integers(0, n, size=(k_uni, 2)),
        np.stack([pool_any[0][pick_any], pool_any[1][pick_any]], 1),
        np.stack([pool_long[0][pick_long], pool_long[1][pick_long]], 1),
        np.stack([rng.choice(long_src, k_long_miss), rng.integers(0, n, k_long_miss)], 1),
    ]).astype(np.int32)
    return q[rng.permutation(q.shape[0])]


def serve_all(co, queries: np.ndarray, backend) -> tuple:
    import torch

    t0 = time.perf_counter()
    out = np.concatenate([co.serve(queries[i:i + BATCH], backend=backend)
                          for i in range(0, queries.shape[0], BATCH)])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tier_outcomes(co, cq: np.ndarray, rest: np.ndarray, verdicts: np.ndarray) -> dict:
    """Hits and misses of the intersection residue (``rest`` marks the
    condensation-id queries ``cq`` the prefilters left), per tier width
    (the planner's assignment, recomputed from the labels)."""
    o, eng = co.oracle, co.engine
    need = np.maximum(o.out_len[cq[rest, 0]], o.in_len[cq[rest, 1]])
    tier = np.minimum(np.searchsorted(eng.widths, need), len(eng.widths) - 1)
    v = verdicts[rest]
    return {int(w): {"hits": int((v & (tier == i)).sum()),
                     "misses": int((~v & (tier == i)).sum())}
            for i, w in enumerate(eng.widths)}


def phase_main_path(device):
    import torch

    from repro_torch.core.api import build_oracle
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.reach import reachable_set
    from repro_torch.kernels import ops
    from repro_torch.serve.prefilter import apply_prefilters

    t0 = time.perf_counter()
    g = paper_dataset_analogue(MAIN_DATASET, scale=MAIN_SCALE)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    co = build_oracle(g, device=device)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    o, eng = co.oracle, co.engine
    check(eng.backend == "kernel", f"backend auto resolved to {eng.backend!r}, not kernel")
    check(o.build_stats["impl"] == "reference", "auto build must resolve to reference")
    record({"phase": "build_oracle", "dataset": MAIN_DATASET, "scale": MAIN_SCALE,
            "n": g.n, "m": g.m, "graph_seconds": t_graph, "build_seconds": t_build,
            "build_stats": o.build_stats,
            "L_out": list(o.L_out.shape), "L_in": list(o.L_in.shape),
            "label_bytes": int(o.L_out.nbytes + o.L_in.nbytes),
            "label_ints": o.total_label_size, "tier_widths": eng.widths})

    t0 = time.perf_counter()
    queries = make_traffic(g, co, MAIN_QUERIES)
    t_traffic = time.perf_counter() - t0
    co.serve(queries[:BATCH])                     # warm-up, outside the count
    torch.cuda.synchronize()
    eng.reset_stats()

    # ---- the counted run: the main path, backend auto
    ops.reset_launches()
    kernel_out, t_kernel = serve_all(co, queries, None)
    launches = dict(ops.LAUNCHES)
    degradation = dict(eng.degradation)
    last = eng.last_stats
    # ----
    check(last["backend"] == "kernel", f"served on {last['backend']!r}")
    check(launches["label_intersect"] > 0, "label_intersect never launched on the main path")
    check(not any(degradation.values()), f"degradation counters moved: {degradation}")

    dense_out, t_dense = serve_all(co, queries, "dense")
    host_out, t_host = serve_all(co, queries, "host")
    check(np.array_equal(kernel_out, host_out),
          f"kernel != host merge on {int((kernel_out != host_out).sum())} queries")
    check(np.array_equal(dense_out, host_out),
          f"dense != host merge on {int((dense_out != host_out).sum())} queries")
    check(not any(eng.degradation.values()), f"degradation counters moved: {eng.degradation}")

    rng = np.random.default_rng(1)
    sample = rng.choice(queries.shape[0], BFS_SAMPLE, replace=False)
    truth = np.array([u == v or bool(reachable_set(g, int(u))[v])
                      for u, v in queries[sample]])
    check(np.array_equal(truth, kernel_out[sample]),
          f"kernel != BFS truth on {int((truth != kernel_out[sample]).sum())} of "
          f"{BFS_SAMPLE} sampled queries")
    cq = co.comp[queries]
    rest = ~apply_prefilters(cq, o.out_len, o.in_len, eng.level).decided
    tiers = tier_outcomes(co, cq, rest, kernel_out)
    for w, rec in tiers.items():
        check(rec["hits"] > 0 and rec["misses"] > 0,
              f"tier {w} must see hits and misses: {rec}")

    record({"phase": "main_path", "n_queries": int(queries.shape[0]), "batch": BATCH,
            "traffic_seconds": t_traffic, "backend": last["backend"],
            "launches": launches, "degradation": degradation,
            "kernel_qps": queries.shape[0] / t_kernel,
            "dense_qps": queries.shape[0] / t_dense,
            "host_qps": queries.shape[0] / t_host,
            "prefiltered_share": 1.0 - rest.sum() / queries.shape[0],
            "positives": int(kernel_out.sum()), "tiers": tiers,
            "equal_host": True, "bfs_sample": BFS_SAMPLE, "equal_bfs": True})
    return co, queries, cq[rest], launches


# ------------------------------------------------------------------ phase 5


def _event_ms(fn, reps: int) -> float:
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(fn) -> tuple:
    """Run ``fn`` once under torch.profiler; returns (wall ms, [(category,
    name, device us)] of every kernel, copy and memset the card ran)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    return wall_ms, [(ev["cat"], ev.get("name", ""), float(ev.get("dur", 0.0)))
                     for ev in events if ev.get("ph") == "X"
                     and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def phase_timing(co, rest: np.ndarray, launches: dict, cases: dict) -> list:
    """K1 and its plain version at the serving shape: B = 4096 queries of
    the main path's intersection residue ``rest`` (condensation ids),
    width 16, on its label matrices."""
    import torch

    from repro_torch.kernels import ops, ref

    o, eng = co.oracle, co.engine
    check(rest.shape[0] >= BATCH, "too few intersection queries to time")
    width = 16
    L_out, L_in = o.device_labels(eng.device)
    q = torch.from_numpy(np.ascontiguousarray(rest[:BATCH])).to(eng.device)
    got = ops.tier_intersect(L_out, L_in, q, width)
    exp = ref.tier_intersect_ref(L_out, L_in, q, width)
    torch.cuda.synchronize()
    max_abs_err = int((got.to(torch.int32) - exp.to(torch.int32)).abs().max())
    check(max_abs_err == 0, "kernel disagrees with its plain version at the timed shape")
    kern = lambda: ops.tier_intersect(L_out, L_in, q, width)  # noqa: E731
    plain = lambda: ref.tier_intersect_ref(L_out, L_in, q, width)  # noqa: E731
    # plain, kernel, kernel, plain: both sides see the same card state
    p1, k1, k2, p2 = (_event_ms(plain, 200), _event_ms(kern, 200),
                      _event_ms(kern, 200), _event_ms(plain, 200))
    kern()
    _, events = _device_events(lambda: [kern() for _ in range(50)])
    device_ms = sum(us for cat, name, us in events
                    if cat == "kernel" and "label_intersect_kernel" in name) / 50 / 1e3
    check(device_ms > 0, "torch.profiler recorded no label_intersect kernel")
    wa, wb = min(width, L_out.shape[1]), min(width, L_in.shape[1])
    B = BATCH
    bytes_moved = B * (8 + 4 * (wa + wb)) + B
    ops_needed = B * wa * wb
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_needed / PEAK_INT32_OPS_PER_S * 1e3
    return [{
        "name": "label_intersect",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/label_intersect.cu",
        "replaces": "src/repro/kernels/label_intersect.py:48",
        "launches": launches["label_intersect"],
        "matches_plain": True,
        "cases_checked": cases["label_intersect"],
        "max_abs_err": max_abs_err,
        "shape": {"B": B, "width": width, "wa": wa, "wb": wb,
                  "L_out": list(L_out.shape), "L_in": list(L_in.shape)},
        "ms": min(k1, k2),
        "ms_runs": [k1, k2],
        "device_ms": device_ms,
        "plain_ms": min(p1, p2),
        "plain_ms_runs": [p1, p2],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": bytes_moved,
        "operations": ops_needed,
        "library_ms": None,
    }]


# ------------------------------------------------------------------ phase 6


def phase_serving_profile(co, queries: np.ndarray, n_batches: int = 64) -> None:
    """Where a serving batch spends its time: the device's busy share over a
    window of the main path (torch.profiler), and the engine's own spans
    (obs tracer): ``engine.batch`` wall time, and the part of it inside
    ``device_call`` (host-to-device copy, launch, device work, copy back)."""
    from repro_torch.obs import trace

    window = queries[:n_batches * BATCH]
    serve_all(co, window[:BATCH], None)
    wall_ms, events = _device_events(lambda: serve_all(co, window, None))
    device_us = {}
    for cat, _, us in events:
        device_us[cat] = device_us.get(cat, 0.0) + us
    # the engine's spans, from an unprofiled run of the same window
    trace.TRACER.clear()
    t0 = time.perf_counter()
    serve_all(co, window, None)
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    spans = {}
    for ev in trace.TRACER.events:
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    trace.TRACER.clear()
    busy_ms = sum(device_us.values()) / 1e3
    check(device_us.get("kernel", 0.0) > 0, "the profiled serving window ran no kernel")
    record({"phase": "serving_profile", "batches": n_batches, "batch": BATCH,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_ms_by_kind": {k: v / 1e3 for k, v in device_us.items()},
            "wall_ms": plain_wall_ms, "span_ms": spans,
            "device_call_share_of_batch": (spans.get("device_call", 0.0)
                                           / spans["engine.batch"])})


# ------------------------------------------------------------------ phase 7


def phase_driver():
    """The serve driver's sweep on the card, a path of its own: the launch
    counts are read around exactly this run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    ops.reset_launches()
    rec = serve.main(["--dataset", "kegg", "--scale", "1.0", "--n-queries", "20000",
                      "--backend", "all", "--device", "cuda"])
    launches = dict(ops.LAUNCHES)
    check(launches["label_intersect"] > 0,
          "label_intersect never launched in the serve driver's sweep")
    check(set(rec["backends"]) == {"host", "dense", "kernel"},
          f"the sweep served {sorted(rec['backends'])}")
    for be, r in rec["backends"].items():
        check(not any(r["degradation"].values()),
              f"[{be}] degradation counters moved: {r['degradation']}")
        check(r["sample_errors"] == 0, f"[{be}] {r['sample_errors']} wrong sampled verdicts")
    record({"phase": "serve_driver", "seconds": time.perf_counter() - t0,
            "launches": launches, "device_name": rec["device_name"],
            "mqps": {be: r["mqps"] for be, r in rec["backends"].items()}})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # the port must be importable from this checkout before anything prints
    import repro_torch.core.api  # noqa: F401
    t_start = time.perf_counter()
    name, smi_line = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    cases = phase_kernel_vs_plain(device)
    co, queries, rest, launches = phase_main_path(device)
    kernels = phase_timing(co, rest, launches, cases)
    phase_serving_profile(co, queries)
    phase_driver()
    record({"phase": "done", "seconds": time.perf_counter() - t_start,
            "card": smi_line})
    log(smi_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
