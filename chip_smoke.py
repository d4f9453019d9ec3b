"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (``nvcc``).  Phases, each raising on failure:

  1. device: the card's name and power limit (from ``nvidia-smi``);
  2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``;
  3. each kernel against its plain PyTorch version on the card over edge
     shapes and widths (exact for K1-K3, whose outputs are verdicts and bit
     patterns; K4 at 2e-5 in float32 and one step in bfloat16, each case
     through the kernel of its dtype, K5 and K6 at 1e-5).  K2 has two
     kernels: its slab form ``frontier_or`` (the counterpart of
     ``repro.kernels.ops.frontier_or``) and its frontier form
     ``frontier_expand`` (the device build's BFS level), whose cases are
     ``tests/frontier_cases.py``'s;
  3b. the kernel library (K3 bitset_mm, K4 flash_attention, K5 ell_spmm,
     K6 embedding_bag), which no oracle path calls, at the widths of
     configurations the repo has: the transitive closure of the "human"
     analogue (byte for byte against ``transitive_closure_bits``),
     attention in bfloat16 (the tensor-core kernel ``flash_attention_sm90``)
     at granite-3-2b prefill, h2o-danube-1.8b sliding-window prefill and
     granite decode_32k and in float32 (the CUDA-core kernel
     ``flash_attention``) at granite prefill, ELL SpMM at ogb_products,
     embedding bags at xDeepFM's serve_bulk batch; the launch counts read
     around exactly that drive; each kernel against its plain version, timed
     beside its bound, its plain version and the PyTorch library call;
  4. the main path: the citeseer analogue at full size (n = 693,947) through
     ``repro_torch.core.api.build_oracle(g, device="cuda").serve(q)`` with
     ``backend="auto"`` (which must resolve to the kernel), about 1M queries
     mixing uniform and reachable pairs; verdicts held against the host
     merge on every query and against BFS truth on a sample; the kernels'
     launch counts read around exactly this run;
  4b. the device wave build: ``build_oracle(g, device="cuda", impl="device")``
     on the same graph, the launch counts read around exactly this build
     (``frontier_expand`` once a BFS level, ``frontier_or`` never); its
     labels byte for byte against phase 4's reference build, phase 4's
     queries served through K1 on it with the same verdicts and every
     degradation counter 0; its build seconds, host reads a wave and cone
     rows a sweep; K2's slab form against its plain version on a real slab
     and frontier; launches a wave and the card's busy share over a
     profiled window of 500 waves;
  5. timing of K1, K2's two kernels and their plain versions with CUDA
     events at the main path's shapes (``frontier_expand`` at a real level
     from the middle of the build's schedule), and the kernels JSON line
     (all eight kernels: K2 and K4 have two each);
  6. where a serving batch spends its time: the device's busy share over a
     window of the main path (torch.profiler) and the engine's spans;
  7. the serve driver (``repro_torch.launch.serve``) on a small graph, a
     second path on the card: its own launch counts, every degradation
     counter 0.

``--only-device-build`` runs phases 1-3 and 4b alone, with 4b's own
reference build, at ``--device-build-scale`` (default 1.0), and times
``frontier_expand``.
``--only-kernels`` runs phases 1-3b alone.

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
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# tests/frontier_cases.py: frontier_expand's edge cases, shared with the card tests
sys.path.insert(1, str(ROOT / "tests"))

# H100 SXM peaks.  HBM bytes/s: NVIDIA's data sheet.  The data sheet gives
# no INT32 rate; its 67 TFLOP/s float32 rate counts an FMA as two operations
# on 128 float32 lanes per SM, and a Hopper SM has 64 INT32 lanes (NVIDIA
# H100 Tensor Core GPU Architecture whitepaper), so one int32 compare per
# lane per clock is 67e12 / 2 / 2
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4
# dense bf16 tensor-core rate (data sheet): K4's bound in bfloat16, on the
# tensor cores; K4 in float32 runs on the CUDA cores and is bound at their
# 67 TFLOP/s float32 rate (data sheet), which K5 and K6 use too
PEAK_BF16_FLOPS_PER_S = 989e12
PEAK_F32_FLOPS_PER_S = 67e12

MAIN_DATASET = "citeseer"
MAIN_SCALE = 1.0
MAIN_QUERIES = 1 << 20
BATCH = 4096
BFS_SAMPLE = 4096
PROFILED_WAVES = 500
LABEL_FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")


def log(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.perf_counter()


def record(obj: dict) -> None:
    """One JSON line per phase, stamped with the seconds since the start."""
    print(json.dumps({**obj, "at_seconds": time.perf_counter() - _T0}), flush=True)


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

    from concurrent.futures import ThreadPoolExecutor

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SIGNATURES)) as pool:
        futures = {name: pool.submit(build.build, name) for name in build.SIGNATURES}
        info = {name: fut.result() for name, fut in futures.items()}
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
    k2 = _frontier_or_vs_plain(rng, t)
    k2f = _frontier_expand_vs_plain(device)
    library = _library_vs_plain(rng, device)
    record({"phase": "kernel_vs_plain", "label_intersect_cases": cases,
            "frontier_or_cases": k2, "frontier_expand_cases": k2f,
            **{f"{k}_cases": v for k, v in library.items()}, "matches_plain": True})
    return {"label_intersect": cases, "frontier_or": k2, "frontier_expand": k2f, **library}


def _check_frontier_expand(case: dict, device, what: str) -> dict:
    """frontier_expand against its plain version on one level's inputs (a
    dict of numpy arrays and ints, ``frontier_cases.ORDER``), on the card:
    every word, stamp and count exactly, the ring's and the cone's new
    entries as sets.  The kernel must launch once unless the level is
    empty.  Returns the kernel's outputs as numpy."""
    import frontier_cases as fc
    import torch

    from repro_torch.kernels import ops, ref

    res = []
    for fn in (ops.frontier_expand, ref.frontier_expand_ref):
        args = {k: (torch.from_numpy(case[k].copy()).to(device) if k in fc.ARRAYS
                    else case[k]) for k in fc.ORDER}
        before = ops.LAUNCHES["frontier_expand"]
        fn(*(args[k] for k in fc.ORDER))
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["frontier_expand"] - before
        check(launched == int(fn is ops.frontier_expand and case["hi"] > case["lo"]),
              f"frontier_expand {what}: {launched} launches")
        res.append({k: (args[k].cpu().numpy() if k in fc.ARRAYS else args[k])
                    for k in fc.ORDER})
    try:
        fc.assert_same_level(case, res[0], res[1], what)
    except AssertionError as e:
        raise AssertionError(f"frontier_expand differs from its plain version: {e}") from None
    return res[0]


def _frontier_expand_vs_plain(device) -> int:
    """K2's frontier form on the edge cases of ``tests/frontier_cases.py``:
    an empty frontier, every row, contention on one target, wm of 1, 2 and
    8, rows of degree 0, a hub of 1,500 neighbors, a bad neighbor id and a
    bad frontier id (both must set the flag), fully pruned rows."""
    import frontier_cases as fc

    for i, name in enumerate(fc.CASES):
        case = fc.make_case(np.random.default_rng(i), name)
        out = _check_frontier_expand(case, device, name)
        check(int(out["counts"][2]) == int(name.startswith("bad_")),
              f"frontier_expand {name}: bad-id flag {int(out['counts'][2])}")
    return len(fc.CASES)


def _check_frontier_or(nbr, f, rng, what: str) -> int:
    """K2 against its plain version on one slab and frontier, in both forms
    (a new output; OR into permuted rows of a running output with flags).
    Exact equality: the words are bit patterns.  Returns the cases checked."""
    import torch

    from repro_torch.kernels import ops, ref

    got = ops.frontier_or(nbr, f)
    exp = ref.frontier_or_ref(nbr, f)
    torch.cuda.synchronize()
    check(torch.equal(got, exp), f"frontier_or {what}")
    r, wm = nbr.shape[0], f.shape[1]
    n_out = r + 3
    perm = torch.from_numpy(rng.permutation(n_out)[:r].astype(np.int64)).to(f.device)
    out0 = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n_out, wm),
                                         dtype=np.int64).astype(np.int32)).to(f.device)
    res = []
    for fn in (ops.frontier_or, ref.frontier_or_ref):
        out, flags = out0.clone(), torch.zeros(2, dtype=torch.int32, device=f.device)
        fn(nbr, f, out=out, perm=perm, flags=flags)
        res.append((out, flags))
    torch.cuda.synchronize()
    check(torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1]),
          f"frontier_or fused form {what}")
    return 2


def _frontier_or_vs_plain(rng, t) -> int:
    """K2 at the JAX package's sweep shapes and at the edges: all-INVALID
    rows, r = 1 with wm = 8, ids at n_src - 1, bit 31 set in every word."""
    cases = 0
    shapes = [(13, 4, 50, 1), (128, 16, 200, 2), (1, 7, 9, 3), (1, 16, 40, 8),
              (70001, 16, 90001, 8)]
    for r, d, n_src, wm in shapes:
        for edge in (None, "all_invalid", "last_id", "bit31"):
            nbr = rng.integers(0, n_src, size=(r, d)).astype(np.int32)
            nbr[rng.random((r, d)) < 0.35] = -1
            f = rng.integers(0, 2**32, size=(n_src, wm), dtype=np.uint32)
            if edge == "all_invalid":
                nbr[: max(r // 2, 1)] = -1
            elif edge == "last_id":
                nbr[:, 0] = n_src - 1
            elif edge == "bit31":
                f |= np.uint32(1 << 31)
            cases += _check_frontier_or(t(nbr), t(f.view(np.int32)), rng,
                                        f"r={r} d={d} n_src={n_src} wm={wm} edge={edge}")
    return cases


# the JAX package's kernel sweeps (tests/test_kernels.py), then edge cases,
# then the shapes of benchmarks/kernel_bench.py
BITSET_CASES = [(16, 32, 32, None), (70, 90, 100, None), (128, 256, 64, None),
                (1, 90, 8, None), (70, 90, 100, "bit31"), (70, 90, 100, "last"),
                (70, 90, 100, "zero"), (1024, 1024, 1024, None)]
ATTENTION_CASES = [(1, 2, 2, 128, 128, 32, True, None), (2, 4, 2, 256, 256, 64, True, None),
                   (1, 4, 1, 128, 128, 64, True, 48), (2, 2, 2, 1, 256, 32, True, None),
                   (1, 2, 2, 128, 256, 32, True, None), (1, 2, 2, 128, 128, 32, False, None),
                   (1, 2, 1, 192, 64, 32, True, None),      # S > T: zero rows
                   (1, 4, 2, 130, 97, 80, True, 40),        # D = 80, window < S
                   (1, 2, 2, 64, 100, 128, False, 24),      # window without causal
                   (1, 8, 2, 1024, 1024, 64, True, None),
                   # the bfloat16 kernel's tile edges (64 packed query rows, 64 keys)
                   (1, 4, 4, 100, 100, 64, True, None),     # rep 1, ragged S and T
                   (1, 2, 2, 256, 256, 64, True, 63),       # window one key inside a tile
                   (1, 2, 2, 256, 256, 64, True, 64),       # window on a tile boundary
                   (1, 2, 2, 256, 256, 64, True, 65),       # window one key past it
                   (1, 2, 2, 128, 192, 32, False, 64),      # window without causal, T > S
                   (1, 8, 1, 77, 200, 64, True, None),      # rep 8
                   (2, 8, 2, 33, 129, 8, True, None),       # D = 8, T one past a tile
                   (1, 4, 2, 70, 130, 24, False, 33),       # D = 24
                   (1, 4, 2, 70, 127, 80, True, 65),        # D = 80, T one short of a tile
                   (1, 4, 1, 50, 190, 128, True, None),     # D = 128
                   (2, 32, 8, 1, 777, 64, True, None),      # decode, ragged last key tile
                   (2, 32, 8, 1, 4097, 128, True, 1000),    # decode, window, D = 128
                   (1, 4, 2, 150, 70, 24, True, None),      # S > T
                   (1, 4, 2, 40, 20, 8, True, None),        # T under one key tile
                   (1, 4, 2, 70, 100, 40, True, None),      # D = 40
                   (1, 2, 1, 64, 90, 72, False, None),      # D = 72
                   (1, 4, 2, 64, 64, 96, True, None),       # D = 96
                   (1, 2, 2, 65, 65, 112, True, 30)]        # D = 112
SPMM_CASES = [(32, 4, 50, 8, None), (96, 7, 200, 32, None), (64, 1, 64, 128, None),
              (96, 7, 200, 100, "all_padding"), (1, 9, 40, 100, None),
              (96, 7, 200, 33, "last_id"), (4096, 16, 4096, 64, "no_padding")]
BAG_CASES = [(100, 8, 32, 4, None), (500, 16, 64, 9, None), (64, 32, 16, 1, None),
             (1000, 10, 300, 8, "all_padding"), (1000, 10, 1, 8, None),
             (1000, 10, 300, 8, "last_id"), (100_000, 16, 8192, 8, "no_padding")]


def _library_vs_plain(rng, device) -> dict:
    """K3-K6 against their plain versions on the card: exact for K3 (bit
    patterns); K4 against the float32 plain version on the same values
    (``_attention_excess``: 2e-5 in float32, one bfloat16 step in
    bfloat16), each case through the kernel of its dtype
    (``ops.attention_kernel``: bfloat16 on the tensor cores, float32 on the
    CUDA cores); 1e-5 for K5 and K6.  Bad ids must raise.  Returns {kernel:
    cases}."""
    import torch

    from repro_torch.kernels import ops, ref

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    cases = dict.fromkeys(("bitset_mm", "flash_attention", "flash_attention_sm90", "ell_spmm",
                           "embedding_bag"), 0)
    for n, k, m, edge in BITSET_CASES:
        wk, wm = (k + 31) // 32, (m + 31) // 32
        a = rng.integers(0, 2**32, size=(n, wk), dtype=np.uint32)
        x = rng.integers(0, 2**32, size=(k, wm), dtype=np.uint32)
        if edge == "bit31":
            a &= np.uint32(1 << 31)
        elif edge == "last":
            a[:] = 0
            a[:, -1] = np.uint32(1) << np.uint32((k - 1) % 32)
        elif edge == "zero":
            a[:] = 0
        a, x = t(a.view(np.int32)), t(x.view(np.int32))
        got = ops.bitset_mm(a, x)
        torch.cuda.synchronize()
        check(torch.equal(got, ref.bitset_mm_ref(a, x)), f"bitset_mm n={n} k={k} m={m} {edge}")
        cases["bitset_mm"] += 1
    for B, Hq, Hkv, S, T, D, causal, window in ATTENTION_CASES:
        q = t(rng.standard_normal((B, Hq, S, D)).astype(np.float32))
        k = t(rng.standard_normal((B, Hkv, T, D)).astype(np.float32))
        v = t(rng.standard_normal((B, Hkv, T, D)).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            name = ops.attention_kernel(dtype)
            before = dict(ops.LAUNCHES)
            got = ops.flash_attention(qd, kd, vd, causal=causal, window=window)
            exp = ref.flash_attention_ref(qd.float(), kd.float(), vd.float(), causal=causal,
                                          window=window)
            torch.cuda.synchronize()
            what = f"flash_attention {dtype} B={B} Hq={Hq} Hkv={Hkv} S={S} T={T} D={D} " \
                   f"causal={causal} window={window}"
            check({n: ops.LAUNCHES[n] - before[n] for n in before} ==
                  {n: int(n == name) for n in before}, f"{what}: not one launch of {name}")
            check(_attention_excess(got, exp) <= 1, what)
            check(not (causal and S > T) or not got[:, :, : S - T].any(), f"{what}: zero rows")
            cases[name] += 1
    for n, d, ns, F, edge in SPMM_CASES:
        nbr = rng.integers(0, ns, size=(n, d)).astype(np.int32)
        if edge != "no_padding":
            nbr[rng.random((n, d)) < 0.3] = -1
        if edge == "all_padding":
            nbr[: n // 2] = -1
        elif edge == "last_id":
            nbr[:, 0] = ns - 1
        nbr = t(nbr)
        wgt = t(rng.standard_normal((n, d)).astype(np.float32))
        x = t(rng.standard_normal((ns, F)).astype(np.float32))
        got = ops.ell_spmm(nbr, wgt, x)
        torch.cuda.synchronize()
        check(torch.allclose(got, ref.ell_spmm_ref(nbr, wgt, x), rtol=1e-5, atol=1e-5),
              f"ell_spmm n={n} d={d} n_src={ns} F={F} {edge}")
        check(edge != "all_padding" or not got[: n // 2].any(), "ell_spmm padding rows")
        cases["ell_spmm"] += 1
    for bad in (-2, 6):
        try:
            ops.ell_spmm(t(np.array([[0, bad]], np.int32)), t(np.ones((1, 2), np.float32)),
                         t(np.ones((6, 4), np.float32)))
        except ValueError:
            cases["ell_spmm"] += 1
        else:
            check(False, f"ell_spmm accepted the id {bad}")
    for V, D, B, bag, edge in BAG_CASES:
        idx = rng.integers(0, V, size=(B, bag)).astype(np.int32)
        if edge != "no_padding":
            pad = rng.random((B, bag)) < 0.25
            idx[pad] = rng.integers(-2**31, 0, size=int(pad.sum()))   # any negative pads
        if edge == "all_padding":
            idx[: B // 2] = -1
        elif edge == "last_id":
            idx[:, 0] = V - 1
        idx = t(idx)
        table = t(rng.standard_normal((V, D)).astype(np.float32))
        got = ops.embedding_bag(table, idx)
        torch.cuda.synchronize()
        check(torch.allclose(got, ref.embedding_bag_ref(table, idx), rtol=1e-5, atol=1e-5),
              f"embedding_bag V={V} D={D} B={B} bag={bag} {edge}")
        check(edge != "all_padding" or not got[: B // 2].any(), "embedding_bag padding bags")
        cases["embedding_bag"] += 1
    try:
        ops.embedding_bag(t(np.ones((6, 10), np.float32)), t(np.array([[0, 6]], np.int32)))
    except ValueError:
        cases["embedding_bag"] += 1
    else:
        check(False, "embedding_bag accepted the id V")
    return cases


# ------------------------------------------------------------------ phase 3b

# K4 at the widths of two LM configurations of the repo (batch cut to 1 for
# prefill) and of the decode_32k cell (src/repro/configs/lm_cells.py), in
# bfloat16 (the tensor-core kernel); granite prefill once more in float32
# (the CUDA-core kernel)
ATTENTION_CONFIGS = [
    ("granite-3-2b prefill (configs/granite_3_2b.py, train_4k length)",
     dict(B=1, Hq=32, Hkv=8, S=4096, T=4096, D=64, causal=True, window=None,
          dtype="bfloat16")),
    ("h2o-danube-1.8b SWA prefill (configs/h2o_danube_1_8b.py, window 4096)",
     dict(B=1, Hq=32, Hkv=8, S=8192, T=8192, D=80, causal=True, window=4096,
          dtype="bfloat16")),
    ("granite-3-2b decode_32k (configs/lm_cells.py)",
     dict(B=128, Hq=32, Hkv=8, S=1, T=32768, D=64, causal=True, window=None,
          dtype="bfloat16")),
    ("granite-3-2b prefill in float32 (configs/granite_3_2b.py, train_4k length)",
     dict(B=1, Hq=32, Hkv=8, S=4096, T=4096, D=64, causal=True, window=None,
          dtype="float32")),
]
# K5 at ogb_products (src/repro/configs/gnn_cells.py): n, m, d_feat; ELL width 32
PRODUCTS = dict(n=2_449_029, m=61_859_140, F=100, d=32)
# K6 at xDeepFM's table (src/repro/configs/xdeepfm_cfg.py: 39 fields x
# 1,000,000 rows, embed_dim 10) and its serve_bulk batch, bags of 8
XDEEPFM = dict(V=39 * 1_000_000, D=10, B=262_144, bag=8, padding=0.25)
PLAIN_CHUNK_BYTES = 1 << 30   # the plain versions' largest intermediate, per chunk
# K4 against its float32 plain version, by output type (rtol, atol): float32
# at the JAX package's 2e-5; bfloat16 against the plain result rounded to
# bfloat16, from which a sound kernel differs by at most one step (2^-7 of the
# value), with an atol far below a decode output (~0.009 at T = 32,768)
ATTENTION_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-4)}


def _timed_once(fn) -> tuple:
    """(ms by CUDA events, result) of one call of ``fn``."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _kernel_device_ms(fn, symbol: str, calls: int, attempts: int = 3) -> float:
    """torch.profiler's device time of kernel ``symbol`` per launch, over
    ``calls`` calls of ``fn`` (one launch each).  The mean is taken over the
    launches the trace holds: a trace has been seen to hold one of two, and
    once none of 50, so a trace that holds none is taken again, up to
    ``attempts`` times."""
    for _ in range(attempts):
        _, events = _device_events(lambda: [fn() for _ in range(calls)])
        times = [us for cat, name, us in events if cat == "kernel" and symbol in name]
        if times:
            break
    check(1 <= len(times) <= calls, f"torch.profiler recorded {len(times)} launches of "
                                    f"{symbol} in {calls} calls, {attempts} times")
    return sum(times) / len(times) / 1e3


def _library_kernels(fn) -> list:
    """The kernels one call of a library function ran, by device time."""
    _, events = _device_events(fn)
    by_name = {}
    for cat, name, us in events:
        if cat == "kernel":
            by_name[name] = by_name.get(name, 0.0) + us
    return [name[:120] for name, _ in sorted(by_name.items(), key=lambda x: -x[1])[:3]]


def _bound(bytes_moved: int, operations: int, peak_ops: float) -> dict:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = operations / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "operations": operations}


def _rows_chunked(fn, n: int, rows: int):
    """fn(slice) over row chunks of ``rows``, concatenated."""
    import torch

    return torch.cat([fn(slice(i, min(i + rows, n))) for i in range(0, n, rows)])


def _attention_excess(got, exp) -> float:
    """The check of K4's output ``got`` against the float32 plain result
    ``exp``: max |got - exp'| / (atol + rtol |exp'|), exp' being exp rounded
    to got's type; the check passes at 1 or less."""
    rtol, atol = ATTENTION_TOL[str(got.dtype).removeprefix("torch.")]
    exp = exp.to(got.dtype).float()
    return float(((got.float() - exp).abs() / (atol + rtol * exp.abs())).max())


def _attention_pairs(S: int, T: int, causal: bool, window) -> int:
    """The (query, key) pairs the masks keep: what the computation needs."""
    qpos = np.arange(S, dtype=np.int64) + T - S
    hi = np.minimum(qpos, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attention_plain_chunked(q, k, v, causal, window):
    """K4's plain version over (batch, kv head) chunks, so no chunk's float32
    logits exceed PLAIN_CHUNK_BYTES; returns the whole output."""
    import torch

    from repro_torch.kernels import ref

    B, Hq, S, _ = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    per_pair = max(rep * S * T * 4 * 3, T * k.shape[3] * 4 * 2)   # logits, mask, exp; k, v
    units = max(1, PLAIN_CHUNK_BYTES // per_pair)
    hc = min(Hkv, units)
    bc = max(1, units // Hkv) if hc == Hkv else 1
    out = torch.empty_like(q)
    for b0 in range(0, B, bc):
        for h0 in range(0, Hkv, hc):
            b1, h1 = min(b0 + bc, B), min(h0 + hc, Hkv)
            out[b0:b1, h0 * rep:h1 * rep] = ref.flash_attention_ref(
                q[b0:b1, h0 * rep:h1 * rep], k[b0:b1, h0:h1], v[b0:b1, h0:h1],
                causal=causal, window=window)
    return out


def phase_kernel_library(device, cases: dict) -> list:
    """The kernel library (K3-K6) at the widths of configurations the repo
    has, through ``repro_torch.kernels.ops``: the transitive closure of the
    "human" analogue by repeated ``R | bitset_mm(R, R)``; attention at
    granite-3-2b prefill, h2o-danube-1.8b sliding-window prefill and granite
    decode_32k in bfloat16 and granite prefill in float32; ELL SpMM at
    ogb_products; embedding bags at xDeepFM's table and serve_bulk batch.
    The launch counts are read around exactly that drive.  Then each kernel
    against its plain version (chunked where its intermediate would be
    large) and its timing beside its bound, the plain version and the
    library call.  Returns the five kernel records (K4 has two kernels)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.reach import adjacency_bits, transitive_closure_bits
    from repro_torch.kernels import ops, ref

    t_start = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(13)

    # ---- inputs, made on the card from the seed (K3's from the graph)
    human = paper_dataset_analogue("human", scale=1.0)
    A = torch.from_numpy(adjacency_bits(human).view(np.int32)).to(device)
    att = []
    for label, c in ATTENTION_CONFIGS:
        shape_q = (c["B"], c["Hq"], c["S"], c["D"])
        shape_kv = (c["B"], c["Hkv"], c["T"], c["D"])
        att.append((label, c, *(torch.randn(sh, generator=gen, device=device,
                                            dtype=getattr(torch, c["dtype"]))
                                for sh in (shape_q, shape_kv, shape_kv))))
    P = PRODUCTS
    lens = torch.randint(18, 33, (P["n"],), generator=gen, device=device)
    deficit = P["m"] - int(lens.sum())
    room = (lens < P["d"]).nonzero().flatten()
    check(0 <= deficit <= room.numel(), f"cannot reach {P['m']} valid slots")
    lens[room[torch.randperm(room.numel(), generator=gen, device=device)[:deficit]]] += 1
    slot = torch.arange(P["d"], device=device)[None, :]
    nbr = torch.randint(0, P["n"], (P["n"], P["d"]), generator=gen, device=device,
                        dtype=torch.int32)
    nbr[slot >= lens[:, None]] = -1        # the valid slots first, as an ELL row lies
    wgt = torch.randn((P["n"], P["d"]), generator=gen, device=device)
    x = torch.randn((P["n"], P["F"]), generator=gen, device=device)
    X = XDEEPFM
    table = torch.randn((X["V"], X["D"]), generator=gen, device=device)
    idx = torch.randint(0, X["V"], (X["B"], X["bag"]), generator=gen, device=device,
                        dtype=torch.int32)
    pad = torch.rand((X["B"], X["bag"]), generator=gen, device=device) < X["padding"]
    idx[pad] = -1 - torch.randint(0, 2**31 - 1, (int(pad.sum()),), generator=gen,
                                  device=device, dtype=torch.int32)
    torch.cuda.synchronize()
    t_inputs = time.perf_counter() - t_start

    # ---- the counted run: each kernel once at its configuration's widths
    ops.reset_launches()
    R, steps = A, 0
    while True:
        new = R | ops.bitset_mm(R, R)
        steps += 1
        if torch.equal(new, R):
            break
        R = new
    att_out = [ops.flash_attention(q, k, v, causal=c["causal"], window=c["window"])
               for _, c, q, k, v in att]
    spmm_out = ops.ell_spmm(nbr, wgt, x)
    bag_out = ops.embedding_bag(table, idx)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    # ----
    for name in ("bitset_mm", "flash_attention", "flash_attention_sm90", "ell_spmm",
                 "embedding_bag"):
        check(launches[name] > 0, f"{name} never launched in the kernel library phase")
    records = []

    # ---- K3: the closure, byte for byte; one step against the plain version
    truth = transitive_closure_bits(human)
    check(np.array_equal(R.cpu().numpy().view(np.uint32), truth),
          "the bitset_mm closure of the human analogue differs from transitive_closure_bits")
    n, wm = R.shape
    kern = lambda: ops.bitset_mm(R, R)  # noqa: E731
    plain = lambda: _rows_chunked(lambda sl: ref.bitset_mm_ref(R[sl], R), n, 256)  # noqa: E731
    p1, exp = _timed_once(plain)
    got = kern()
    torch.cuda.synchronize()
    check(torch.equal(got, exp), "bitset_mm differs from its plain version on the closure step")
    k1, k2 = _event_ms(kern, 20, warmup=3), _event_ms(kern, 20, warmup=3)
    p2, _ = _timed_once(plain)
    set_bits = sum(int(ref.unpack_bits(R[i:i + 4096], n).sum()) for i in range(0, n, 4096))
    records.append({
        "name": "bitset_mm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitset_mm.cu",
        "replaces": "src/repro/kernels/bitset_mm.py:67",
        "launches": launches["bitset_mm"], "matches_plain": True,
        "cases_checked": cases["bitset_mm"] + 1, "max_abs_err": 0,
        "config": 'closure of paper_dataset_analogue("human", 1.0)',
        "shape": {"n": n, "k": n, "wm": wm, "set_bits": set_bits, "closure_steps": steps,
                  "closure_equal": True},
        "ms": min(k1, k2), "ms_runs": [k1, k2],
        "device_ms": _kernel_device_ms(kern, "bitset_mm_kernel", 10),
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
        # R is both a and x: read once, out written once; one OR per set bit
        # and word
        **_bound(2 * n * wm * 4, set_bits * wm, PEAK_INT32_OPS_PER_S),
        # no PyTorch call computes an OR-AND product of packed words
        "library_ms": None})
    del A, R, new, got, exp
    torch.cuda.empty_cache()

    # ---- K4: each configuration against the float32 plain version and SDPA,
    # through the kernel of its dtype (the plain version's products in full
    # float32: TF32 stays off)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    configs = []
    for (label, c, q, k, v), out in zip(att, att_out):
        kernel = ops.attention_kernel(q.dtype)
        exp = _attention_plain_chunked(q.float(), k.float(), v.float(), c["causal"],
                                       c["window"])
        err = float((out.float() - exp).abs().max())
        excess = _attention_excess(out, exp)
        check(excess <= 1, f"flash_attention differs from its plain version at {label}: "
                           f"max abs error {err}, {excess} times the tolerance")
        # controls the check must reject: a zeroed output and, at decode, the
        # output without every fourth 32-key chunk, taken on the first 8
        # batch entries
        controls = {"zeroed": _attention_excess(torch.zeros_like(out), exp)}
        if c["S"] == 1:
            keep = (torch.arange(c["T"], device=device) // 32) % 4 != 0
            part = _attention_plain_chunked(q[:8].float(), k[:8, :, keep].float(),
                                            v[:8, :, keep].float(), c["causal"], c["window"])
            controls["dropped_chunks"] = _attention_excess(part.to(out.dtype), exp[:8])
            del part
        check(all(x > 1 for x in controls.values()),
              f"the flash_attention check at {label} passes a wrong output: {controls}")
        exp_rms = float(exp.pow(2).mean().sqrt())
        del exp
        kern = lambda: ops.flash_attention(q, k, v, causal=c["causal"],  # noqa: E731
                                           window=c["window"])
        plain = lambda: _attention_plain_chunked(q, k, v, c["causal"], c["window"])  # noqa: E731
        check(c["S"] == c["T"] or c["S"] == 1, "SDPA aligns causal masks top-left")
        if c["window"] is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=c["causal"] and c["S"] > 1, enable_gqa=True)
        else:
            mask = ref.attention_mask(c["S"], c["T"], c["causal"], c["window"], device)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        lib_err = float((lib().float() - out.float()).abs().max())
        p1, _ = _timed_once(plain)
        k1, k2 = _event_ms(kern, 3, warmup=1), _event_ms(kern, 3, warmup=1)
        p2, _ = _timed_once(plain)
        l1, l2 = _event_ms(lib, 3, warmup=1), _event_ms(lib, 3, warmup=1)
        device_ms = _kernel_device_ms(kern, f"{kernel}_kernel", 2)
        pairs = _attention_pairs(c["S"], c["T"], c["causal"], c["window"])
        flops = 4 * pairs * c["D"] * c["Hq"] * c["B"]
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + out.numel())
        bound = _bound(nbytes, flops, PEAK_BF16_FLOPS_PER_S if q.dtype == torch.bfloat16
                       else PEAK_F32_FLOPS_PER_S)
        configs.append({
            "kernel": kernel, "config": label, "shape": c, "dtype": c["dtype"],
            "visible_pairs": pairs,
            "max_abs_err": err, "max_excess": excess, "controls_excess": controls,
            "exp_rms": exp_rms,
            "tolerance": dict(zip(("rtol", "atol"), ATTENTION_TOL[c["dtype"]]),
                              against=f"the float32 plain result rounded to {c['dtype']}"),
            "ms": min(k1, k2), "ms_runs": [k1, k2], "device_ms": device_ms,
            "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2], **bound,
            # the rates the kernel reached on the device, and its share of the bound
            "tflop_per_s": flops / device_ms / 1e9, "gb_per_s": nbytes / device_ms / 1e6,
            "bound_share": bound["bound_ms"] / device_ms,
            "library_ms": min(l1, l2), "library_ms_runs": [l1, l2],
            "library": "F.scaled_dot_product_attention(enable_gqa=True"
                       + (", explicit mask)" if c["window"] is not None else ")"),
            "library_kernels": _library_kernels(lib), "library_max_abs_diff": lib_err})
        log(f"K4 {kernel} {label}: {min(k1, k2):.3f} ms (device {device_ms:.3f} ms, "
            f"{configs[-1]['tflop_per_s']:.1f} TFLOP/s), plain {min(p1, p2):.3f} ms, "
            f"SDPA {min(l1, l2):.3f} ms, bound {bound['bound_ms']:.4f} ms")
    del att, att_out
    torch.cuda.empty_cache()
    for kernel, source in (("flash_attention_sm90", "flash_attention_sm90.cu"),
                           ("flash_attention", "flash_attention.cu")):
        mine = [rec for rec in configs if rec["kernel"] == kernel]
        head = mine[0]
        records.append({
            "name": kernel, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:110",
            "launches": launches[kernel], "matches_plain": True,
            "cases_checked": cases[kernel] + len(mine),
            **{k: head[k] for k in ("config", "shape", "max_abs_err", "ms", "ms_runs",
                                    "device_ms", "plain_ms", "plain_ms_runs", "bound_ms",
                                    "bound_by", "bytes", "operations", "library_ms")},
            "configs": mine})

    # ---- K5: ogb_products against the plain version (row chunks) and CSR SpMM
    n, d = nbr.shape
    valid = int(lens.sum())
    kern = lambda: ops.ell_spmm(nbr, wgt, x)  # noqa: E731
    plain = lambda: _rows_chunked(  # noqa: E731
        lambda sl: ref.ell_spmm_ref(nbr[sl], wgt[sl], x), n, 1 << 17)
    p1, exp = _timed_once(plain)
    err = float((spmm_out - exp).abs().max())
    check(torch.allclose(spmm_out, exp, rtol=1e-5, atol=1e-5),
          f"ell_spmm differs from its plain version at ogb_products: {err}")
    del exp
    k1, k2 = _event_ms(kern, 10, warmup=2), _event_ms(kern, 10, warmup=2)
    p2, _ = _timed_once(plain)
    keep = nbr >= 0
    crow = torch.zeros(n + 1, dtype=torch.int64, device=device)
    crow[1:] = keep.sum(1).cumsum(0)
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(crow, nbr[keep].long(), wgt[keep], size=(n, x.shape[0]))
    lib = lambda: torch.sparse.mm(csr, x)  # noqa: E731
    lib_err = float((lib() - spmm_out).abs().max())
    l1, l2 = _event_ms(lib, 10, warmup=2), _event_ms(lib, 10, warmup=2)
    F_ = x.shape[1]
    records.append({
        "name": "ell_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell_spmm.cu",
        "replaces": "src/repro/kernels/ell_spmm.py:61",
        "launches": launches["ell_spmm"], "matches_plain": True,
        "cases_checked": cases["ell_spmm"] + 1, "max_abs_err": err,
        "config": "ogb_products (configs/gnn_cells.py)",
        "shape": {"n": n, "d": d, "n_src": x.shape[0], "F": F_, "valid_slots": valid},
        "ms": min(k1, k2), "ms_runs": [k1, k2],
        "device_ms": _kernel_device_ms(kern, "ell_spmm_kernel", 5),
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
        # ids, weights and out once, and x once; one multiply-add per valid
        # slot and feature
        **_bound(n * d * 8 + n * F_ * 4 + x.numel() * 4, 2 * valid * F_, 67e12),
        "gather_bytes_no_reuse": valid * F_ * 4,
        "library_ms": min(l1, l2), "library_ms_runs": [l1, l2],
        "library": "torch.sparse.mm(CSR built outside the timed window, x)",
        "library_kernels": _library_kernels(lib), "library_max_abs_diff": lib_err})
    del nbr, wgt, x, spmm_out, csr, keep, crow, lens
    torch.cuda.empty_cache()

    # ---- K6: xDeepFM's table and serve_bulk batch
    B, bag = idx.shape
    valid = int((idx >= 0).sum())
    kern = lambda: ops.embedding_bag(table, idx)  # noqa: E731
    plain = lambda: ref.embedding_bag_ref(table, idx)  # noqa: E731
    p1, exp = _timed_once(plain)
    err = float((bag_out - exp).abs().max())
    check(torch.allclose(bag_out, exp, rtol=1e-5, atol=1e-5),
          f"embedding_bag differs from its plain version at serve_bulk: {err}")
    k1, k2 = _event_ms(kern, 50), _event_ms(kern, 50)
    p2, _ = _timed_once(plain)
    idx_lib, weights = idx.clamp_min(0).long(), (idx >= 0).float()
    lib = lambda: F.embedding_bag(idx_lib, table, mode="sum",  # noqa: E731
                                  per_sample_weights=weights)
    lib_err = float((lib() - bag_out).abs().max())
    l1, l2 = _event_ms(lib, 50), _event_ms(lib, 50)
    D = table.shape[1]
    records.append({
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:52",
        "launches": launches["embedding_bag"], "matches_plain": True,
        "cases_checked": cases["embedding_bag"] + 1, "max_abs_err": err,
        "config": "xDeepFM table, serve_bulk batch (configs/xdeepfm_cfg.py)",
        "shape": {"V": table.shape[0], "D": D, "B": B, "bag": bag, "valid_slots": valid},
        # the wrapper's call includes its one host read of the bad-id flag
        "ms": min(k1, k2), "ms_runs": [k1, k2],
        "device_ms": _kernel_device_ms(kern, "embedding_bag_kernel", 20),
        "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
        # ids once, one table row per valid slot, out once; one add per value
        **_bound(B * bag * 4 + valid * D * 4 + B * D * 4, valid * D, 67e12),
        "library_ms": min(l1, l2), "library_ms_runs": [l1, l2],
        "library": "F.embedding_bag(idx.clamp_min(0), table, mode='sum', "
                   "per_sample_weights=(idx >= 0)), both made outside the timed window",
        "library_kernels": _library_kernels(lib), "library_max_abs_diff": lib_err})
    del table, idx, bag_out, exp, idx_lib, weights
    torch.cuda.empty_cache()

    record({"phase": "kernel_library", "seconds": time.perf_counter() - t_start,
            "inputs_seconds": t_inputs, "launches": launches, "closure_steps": steps,
            "kernels": records})
    return records


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
    return co, queries, cq[rest], launches, kernel_out


# ------------------------------------------------------------------ phase 4b


def _device_window(dag, order, waves, device) -> dict:
    """Profile the device build over the schedule's first ``len(waves)``
    waves: the card's busy share between the first wave's start and the last
    wave's end (the engine's ``build.wave`` spans, mirrored into
    torch.profiler), with the device time by kind, the host's time in CUDA
    runtime calls and its time by operator.  The same window is first run
    without the profiler, timed by the tracer's own ``build.wave`` spans,
    since the profiler slows the host."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.build.engine_device import distribution_labeling_device
    from repro_torch.obs import trace

    def wave_window_us(evs):
        spans = [ev for ev in evs if ev.get("name") == "build.wave" and ev.get("ph") == "X"]
        check(len(spans) == len(waves), f"{len(spans)} build.wave spans for {len(waves)} waves")
        return (min(float(ev["ts"]) for ev in spans),
                max(float(ev["ts"]) + float(ev["dur"]) for ev in spans))

    trace.TRACER.clear()
    distribution_labeling_device(dag, order=order, waves=waves, device=device)
    torch.cuda.synchronize()
    u0, u1 = wave_window_us(list(trace.TRACER.events))
    trace.TRACER.clear()
    trace.TRACER.profiler_annotations = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            distribution_labeling_device(dag, order=order, waves=waves, device=device)
            torch.cuda.synchronize()
    finally:
        trace.TRACER.profiler_annotations = False
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = [ev for ev in json.loads(path.read_text()).get("traceEvents", [])
                  if ev.get("ph") == "X"]
    t0, t1 = wave_window_us([ev for ev in events if ev.get("cat") == "user_annotation"])
    by_kind = {"frontier_expand": 0.0, "other_kernels": 0.0, "memcpy": 0.0, "memset": 0.0}
    for ev in events:
        cat = ev.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        a, b = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))
        us = max(0.0, min(b, t1) - max(a, t0))
        if cat == "kernel":
            key = ("frontier_expand" if "frontier_expand_kernel" in ev.get("name", "")
                   else "other_kernels")
        else:
            key = "memcpy" if cat == "gpu_memcpy" else "memset"
        by_kind[key] += us
    busy_us = sum(by_kind.values())
    check(by_kind["frontier_expand"] > 0, "the profiled window ran no frontier_expand kernel")
    # host time in CUDA runtime calls inside the window (leaf events: their
    # durations are their own): launches, copies and synchronisations
    runtime = {}
    for ev in events:
        if ev.get("cat") in ("cuda_runtime", "cuda_driver") and t0 <= float(ev["ts"]) <= t1:
            ms, count = runtime.get(ev.get("name", ""), (0.0, 0))
            runtime[ev.get("name", "")] = (ms + float(ev.get("dur", 0.0)) / 1e3, count + 1)
    # the host's time by operator over the whole profiled build (the torch
    # ops and CUDA runtime calls that cost it the most, self time)
    ops_by_host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    return {"waves": len(waves), "members": int(np.sum(waves)),
            "host_ops": [{"name": e.key, "count": e.count, "self_ms": e.self_cpu_time_total / 1e3}
                         for e in ops_by_host],
            "window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / (t1 - t0),
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
            "ms_per_wave": (t1 - t0) / 1e3 / len(waves),
            "unprofiled_window_ms": (u1 - u0) / 1e3,
            "unprofiled_ms_per_wave": (u1 - u0) / 1e3 / len(waves),
            # the profiled device time over the unprofiled window: an estimate
            # of the busy share without the profiler's host overhead
            "device_busy_share_unprofiled_window": busy_us / (u1 - u0),
            "host_runtime_calls": {k: {"ms": ms, "count": c} for k, (ms, c) in
                                   sorted(runtime.items(), key=lambda x: -x[1][0])}}


class _LevelCapture:
    """Wraps ``ops.FrontierExpand.__call__`` (the build's one call a level)
    for one build and keeps a copy of the inputs of one real level: the
    first with at least ``min_rows`` frontier rows at or after sweep
    ``sweep_at`` (a sweep's first level starts at ring position 0), in the
    order of ``frontier_expand``'s arguments.  The wrapped call runs
    unchanged and counts its launch as before; the copies are
    device-to-device copies, not kernel launches."""

    def __init__(self, sweep_at: int, min_rows: int = 8):
        self.sweep_at, self.min_rows = sweep_at, min_rows
        self.sweeps, self.args, self.at = 0, None, None

    def __enter__(self):
        from repro_torch.kernels import ops

        self.wrapped = ops.FrontierExpand.__call__
        capture = self

        def call(ex, lo, hi, delta_cur, delta_next, L_tgt, sweep, level):
            capture.sweeps += lo == 0
            if (capture.args is None and capture.sweeps > capture.sweep_at
                    and hi - lo >= capture.min_rows):
                capture.args = [t.clone() if hasattr(t, "clone") else t for t in (
                    ex.frontier, lo, hi, ex.indptr, ex.indices, ex.v, ex.pruned, delta_cur,
                    delta_next, L_tgt, ex.hop_mask, ex.stamps, sweep, level, ex.cone,
                    ex.counts)]
                capture.at = {"sweep": capture.sweeps - 1, "frontier_rows": hi - lo}
            return capture.wrapped(ex, lo, hi, delta_cur, delta_next, L_tgt, sweep, level)

        ops.FrontierExpand.__call__ = call
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.FrontierExpand.__call__ = self.wrapped


def phase_device_build(device, scale, ref_co=None, queries=None, verdicts=None) -> dict:
    """The device wave build of citeseer@``scale`` on the card, held byte for
    byte against the reference build (phase 4's at full size, else its own)
    and served through K1 with the reference oracle's verdicts.  Returns
    {"launches": the build's kernel launches, "frontier_or_cases": K2 slab
    cases checked, "real_slab": a real slab and frontier for phase 5,
    "level": a real level's inputs from the middle of the schedule}."""
    import torch

    from repro_torch.build import bitset
    from repro_torch.build.waves import wave_schedule
    from repro_torch.core.api import build_oracle
    from repro_torch.core.order import get_order
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.scc import condense_to_dag
    from repro_torch.kernels import ops, ref

    g = paper_dataset_analogue(MAIN_DATASET, scale=scale)
    rec = {"phase": "device_build", "dataset": MAIN_DATASET, "scale": scale,
           "n": g.n, "m": g.m}
    if ref_co is None:
        t0 = time.perf_counter()
        ref_co = build_oracle(g, device=device, impl="reference")
        rec["reference_build_seconds"] = time.perf_counter() - t0
        queries = np.random.default_rng(0).integers(0, g.n, (64 * BATCH, 2)).astype(np.int32)
        verdicts, _ = serve_all(ref_co, queries, None)
    dag, _ = condense_to_dag(g)
    order = get_order(dag, "degree_product")
    waves = wave_schedule(dag, order, max_wave=256)

    # ---- the counted run: the device build (a copy of one level's inputs
    # is kept from the middle sweep on, for phase 5)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _LevelCapture(sweep_at=waves.shape[0]) as level:
        co = build_oracle(g, device=device, impl="device")
        torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # ----
    st = co.oracle.build_stats
    dev = st["device"]
    check(st["impl"] == "device", f"impl={st['impl']!r}")
    check(launches["frontier_expand"] > 0, "frontier_expand never launched in the device build")
    check(launches["frontier_expand"] == dev["levels"],
          f"{launches['frontier_expand']} frontier_expand launches for {dev['levels']} levels")
    check(launches["frontier_or"] == 0, "the device build launched the slab-form frontier_or")
    check(dev["host_reads"] == dev["levels"] + dev["sweeps"],
          f"{dev['host_reads']} host reads for {dev['levels']} levels and {dev['sweeps']} sweeps")
    check(level.args is not None, "no level of the middle sweeps was captured")
    for f in LABEL_FIELDS:
        a, b = getattr(ref_co.oracle, f), getattr(co.oracle, f)
        check(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(),
              f"device build {f} differs from the reference build")
    co.engine.reset_stats()
    ops.reset_launches()
    got, t_serve = serve_all(co, queries, None)
    serve_launches = dict(ops.LAUNCHES)
    check(co.engine.last_stats["backend"] == "kernel", "the device-built oracle was not "
          "served on the kernel backend")
    check(serve_launches["label_intersect"] > 0, "label_intersect never launched")
    check(np.array_equal(got, verdicts),
          f"device-built oracle differs on {int((got != verdicts).sum())} verdicts")
    check(not any(co.engine.degradation.values()),
          f"degradation counters moved: {co.engine.degradation}")
    check(waves.shape[0] == st["n_waves"], "the schedule differs from the build's")
    rec.update({
        "build_seconds": t_build, "schedule_seconds": st["schedule_seconds"],
        "sweep_seconds": st["sweep_seconds"], "n_waves": st["n_waves"],
        "sweeps": dev["sweeps"], "bfs_levels": dev["levels"],
        "host_reads": dev["host_reads"], "regrows": dev["regrows"],
        "host_reads_per_wave": dev["host_reads"] / st["n_waves"],
        "levels_per_sweep": dev["levels"] / dev["sweeps"],
        "cone_rows_per_sweep": {"mean": dev["cone_rows_mean"], "p99": dev["cone_rows_p99"],
                                "max": dev["cone_rows_max"]},
        "l_max": dev["l_max"], "member_width": dev["member_width"],
        "launches": launches, "labels_equal_reference": True,
        "sweep_ms_per_wave": st["sweep_seconds"] * 1e3 / st["n_waves"],
        "served_queries": int(queries.shape[0]), "serve_seconds": t_serve,
        "serve_launches": serve_launches, "verdicts_equal_reference": True,
        "degradation": dict(co.engine.degradation), "timed_level": level.at})
    del co

    # K2's slab form on a real slab and frontier: the out-slab (reverse
    # sweeps) and the first wave's members expanded three unpruned levels
    perm, _, slabs = bitset.ell_slabs(dag.indptr.astype(np.int64),
                                      dag.indices.astype(np.int64), dag.n, width=16)
    w = int(dev["member_width"])
    wm = (w + 31) // 32
    slab = torch.from_numpy(slabs[0]).to(device)
    perm_r = torch.from_numpy(perm[: slabs[0].shape[0]].copy()).to(device)
    j = np.arange(int(waves[0]))
    v = torch.zeros((dag.n, wm), dtype=torch.int32, device=device)
    v[torch.from_numpy(order[: j.size]).to(device), torch.from_numpy(j // 32).to(device)] = \
        torch.from_numpy((np.uint32(1) << (j % 32).astype(np.uint32)).view(np.int32)).to(device)
    flags = torch.zeros(2, dtype=torch.int32, device=device)
    for _ in range(3):
        ref.frontier_or_ref(slab, v.clone(), out=v, perm=perm_r, flags=flags)
    rng = np.random.default_rng(5)
    cases = _check_frontier_or(slab, v, rng, "real out-slab and frontier")
    rec["real_slab"] = {"r": int(slab.shape[0]), "d": int(slab.shape[1]), "wm": wm,
                        "frontier_rows": int(v.ne(0).any(1).sum())}

    win = rec["profiled_window"] = _device_window(dag, order, waves[:PROFILED_WAVES], device)
    calls = win["host_runtime_calls"]
    rec["launches_per_wave"] = {name: calls[name]["count"] / win["waves"]
                                for name in ("cudaLaunchKernel", "cudaLaunchKernelExC")
                                if name in calls}
    record(rec)
    log(f"device build {MAIN_DATASET}@{scale}: build_seconds {t_build:.3f}, "
        f"{st['n_waves']} waves, {dev['levels']} levels, {launches['frontier_expand']} "
        f"frontier_expand launches; launches a wave {rec['launches_per_wave']} (first "
        f"{win['waves']} waves); host reads a wave {rec['host_reads_per_wave']:.3f}; cone "
        f"rows a sweep mean {dev['cone_rows_mean']:.2f} p99 {dev['cone_rows_p99']:.1f}; "
        f"busy {win['device_busy_share']:.4f} profiled")
    return {"launches": launches, "frontier_or_cases": cases, "real_slab": (slab, v, perm_r),
            "level": level.args}


# ------------------------------------------------------------------ phase 5


def _event_ms(fn, reps: int, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
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
    device_ms = _kernel_device_ms(kern, "label_intersect_kernel", 50)
    wa, wb = min(width, L_out.shape[1]), min(width, L_in.shape[1])
    B = BATCH
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
        # two ids and two truncated rows read, a verdict byte written; one
        # int32 compare per pair of entries
        **_bound(B * (8 + 4 * (wa + wb)) + B, B * wa * wb, PEAK_INT32_OPS_PER_S),
        "library_ms": None,
    }]


def timing_frontier_or(real, launches: int, cases: int) -> dict:
    """K2's slab form and its plain version, fused, at the real out-slab and
    frontier of phase 4b: out[perm[i]] |= OR of the frontier words of row
    i's neighbors.  No build path launches it since the frontier form; its
    bound counts the whole slab."""
    import torch

    from repro_torch.kernels import ops, ref

    slab, f, perm_r = real
    out = f.clone()
    flags = torch.zeros(2, dtype=torch.int32, device=f.device)
    exp_out, exp_flags = out.clone(), flags.clone()
    ops.frontier_or(slab, f, out=out, perm=perm_r, flags=flags)
    ref.frontier_or_ref(slab, f, out=exp_out, perm=perm_r, flags=exp_flags)
    torch.cuda.synchronize()
    max_abs_err = int((out.long() - exp_out.long()).abs().max())
    check(max_abs_err == 0 and torch.equal(flags, exp_flags),
          "frontier_or disagrees with its plain version at the timed shape")
    kern = lambda: ops.frontier_or(slab, f, out=out, perm=perm_r, flags=flags)  # noqa: E731
    plain = lambda: ref.frontier_or_ref(slab, f, out=exp_out, perm=perm_r,  # noqa: E731
                                        flags=exp_flags)
    p1, k1, k2, p2 = (_event_ms(plain, 50), _event_ms(kern, 200),
                      _event_ms(kern, 200), _event_ms(plain, 50))
    device_ms = _kernel_device_ms(kern, "frontier_or_kernel", 50)
    r, d = slab.shape
    wm = f.shape[1]
    valid = int(slab.ne(-1).sum())
    # ids once, the frontier words of every valid slot, perm, and the out rows
    # read once; the timed calls write no word (the first call already ORed
    # everything in), so no write is counted
    bytes_moved = r * d * 4 + valid * wm * 4 + r * 8 + r * wm * 4
    ops_needed = valid * wm  # one OR per gathered word
    return {
        "name": "frontier_or",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frontier_or.cu",
        "replaces": "src/repro/kernels/frontier_ell.py:61",
        "launches": launches,
        "matches_plain": True,
        "cases_checked": cases,
        "max_abs_err": max_abs_err,
        "shape": {"r": r, "d": d, "n_src": int(f.shape[0]), "wm": wm,
                  "valid_slots": valid, "form": "fused"},
        "ms": min(k1, k2),
        "ms_runs": [k1, k2],
        "device_ms": device_ms,
        "plain_ms": min(p1, p2),
        "plain_ms_runs": [p1, p2],
        **_bound(bytes_moved, ops_needed, PEAK_INT32_OPS_PER_S),
        # no single PyTorch call computes an OR-reduction gather
        "library_ms": None,
    }


def timing_frontier_expand(level: list, launches: int, cases: int) -> dict:
    """K2's frontier form and its plain version at a real level of phase
    4b's build (a sweep in the middle of the schedule): checked against the
    plain version, then each call timed alone with CUDA events after the
    level's state is restored (a level runs once, and the build reads the
    host after every level, so calls do not overlap)."""
    import frontier_cases as fc
    import torch

    from repro_torch.kernels import ops, ref

    base = dict(zip(fc.ORDER, level))
    case = {k: (base[k].cpu().numpy() if k in fc.ARRAYS else base[k]) for k in fc.ORDER}
    out = _check_frontier_expand(case, base["v"].device, "a real level of the build")
    state = {k: base[k].clone() for k in ("frontier", "v", "pruned", "delta_cur", "delta_next",
                                          "stamps", "cone", "counts")}
    args = [state.get(k, base[k]) for k in fc.ORDER]

    def restore():
        for k, t in state.items():
            t.copy_(base[k])

    def per_call_ms(fn, reps: int) -> list:
        times = []
        for _ in range(reps):
            restore()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    p1, k1 = per_call_ms(ref.frontier_expand_ref, 20), per_call_ms(ops.frontier_expand, 200)
    k2, p2 = per_call_ms(ops.frontier_expand, 200), per_call_ms(ref.frontier_expand_ref, 20)
    device_ms = _kernel_device_ms(lambda: (restore(), ops.frontier_expand(*args)),
                                  "frontier_expand_kernel", 50)

    # the work this level needs (each input read once, each output written
    # once): the frontier rows' ids, CSR offsets, verdict stamps, pushed and
    # cleared words and verdicts; the label rows and the distinct hop-mask
    # rows of the rows that compute a verdict; each edge's neighbor id; the
    # distinct targets' visited words (read, and written where they gained),
    # the gained rows' delta words and stamps, the claims' ring and cone
    # entries; one OR per edge word and per hop word
    lo, hi, cap = case["lo"], case["hi"], case["frontier"].shape[0]
    rows = case["frontier"][np.arange(lo, hi) % cap].astype(np.int64)
    k = rows.size
    n, wm = case["v"].shape
    l_max = case["L_tgt"].shape[1]
    fresh = rows[case["stamps"][1, rows] != case["sweep"]]
    hops = case["L_tgt"][fresh].ravel()
    n_hop = np.unique(hops[hops >= 0]).size
    e0, e1 = case["indptr"][rows], case["indptr"][rows + 1]
    edges = np.concatenate([np.arange(a, b) for a, b in zip(e0, e1)]) if k else np.zeros(0, int)
    targets = np.unique(case["indices"][edges])
    gained = int((out["v"] != case["v"]).any(1).sum())
    claims = int(out["counts"][0] - case["counts"][0])
    joined = int(out["counts"][1] - case["counts"][1])
    nbytes = (k * (4 + 16 + 4 + 3 * wm * 4) + fresh.size * (l_max * 4 + wm * 4 + 4)
              + n_hop * wm * 4 + edges.size * 4 + targets.size * wm * 4
              + gained * (3 * wm * 4 + 4) + claims * 8 + joined * 8 + 24)
    ops_needed = (edges.size + fresh.size * l_max) * wm
    return {
        "name": "frontier_expand",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frontier_expand.cu",
        "replaces": "src/repro/kernels/frontier_ell.py:61",
        "launches": launches,
        "matches_plain": True,
        "cases_checked": cases,
        "max_abs_err": 0,
        "shape": {"n": n, "wm": wm, "l_max": l_max, "frontier_rows": k,
                  "verdict_rows": int(fresh.size), "hop_rows": n_hop,
                  "edges": int(edges.size), "targets": int(targets.size),
                  "gained_rows": gained, "claims": claims, "cone_joins": joined},
        "ms": float(np.median(k1 + k2)), "ms_min": min(k1 + k2),
        "ms_runs": [float(np.median(k1)), float(np.median(k2))],
        "device_ms": device_ms,
        "plain_ms": float(np.median(p1 + p2)), "plain_ms_runs": [float(np.median(p1)),
                                                                  float(np.median(p2))],
        **_bound(nbytes, ops_needed, PEAK_INT32_OPS_PER_S),
        # no PyTorch call pushes packed words over a CSR with claims
        "library_ms": None,
    }


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


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device-build-scale", type=float, default=MAIN_SCALE,
                    help="citeseer scale of the device build phase (4b)")
    ap.add_argument("--only-device-build", action="store_true",
                    help="run phases 1-3 and 4b only, with 4b's own reference build")
    ap.add_argument("--only-kernels", action="store_true",
                    help="run phases 1-3 and 3b (the kernel library) only")
    args = ap.parse_args(argv)
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
    if args.only_device_build:
        built = phase_device_build(device, args.device_build_scale)
        kernels = [timing_frontier_expand(built["level"], built["launches"]["frontier_expand"],
                                          cases["frontier_expand"] + 1)]
    elif args.only_kernels:
        kernels = phase_kernel_library(device, cases)
    else:
        library = phase_kernel_library(device, cases)
        co, queries, rest, launches, verdicts = phase_main_path(device)
        same = args.device_build_scale == MAIN_SCALE
        built = phase_device_build(
            device, args.device_build_scale, *((co, queries, verdicts) if same else ()))
        cases["frontier_or"] += built["frontier_or_cases"]
        kernels = phase_timing(co, rest, launches, cases)
        kernels.append(timing_frontier_expand(built["level"],
                                              built["launches"]["frontier_expand"],
                                              cases["frontier_expand"] + 1))
        kernels.append(timing_frontier_or(built["real_slab"], built["launches"]["frontier_or"],
                                          cases["frontier_or"]))
        kernels += library
        phase_serving_profile(co, queries)
        phase_driver()
    record({"phase": "done", "seconds": time.perf_counter() - t_start,
            "card": smi_line})
    log(smi_line)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
