"""Time versions of one of the port's CUDA kernels on one card, in turns.

    python3 tools/kernel_ab.py {bitset_mm,ell_spmm,flash_attention,embedding_bag,
                                label_intersect,frontier_or,flash_attention_bwd_sm90}
                               SOURCE.cu [SOURCE.cu ...]

Each SOURCE exports the launch function that ``kernels/build.py``'s
``SIGNATURES`` gives the kernel: this checkout's ``csrc/<kernel>.cu``, an
earlier one (``git show <commit>:src/repro_torch/kernels/csrc/<kernel>.cu``)
or a candidate design.  ``embedding_bag``'s flag is a word of pinned host
memory, which sources from before it moved there write through its
mapping as they wrote a device word (only on a bad id); a source whose
launch function takes one more parameter is given a device flag word
before it (cleared and copied back by the launch function).  All are
compiled at once with build.py's ``nvcc`` flags (and ``-I`` of each
source's own directory, for the ``csrc/*.cuh`` headers a copy of it
includes) and loaded with ctypes; each is held against the kernel's plain
version at ``chip_smoke.py``'s shapes (phase 3b's: the closure step of the
"human" analogue for bitset_mm, exact; ogb_products for ell_spmm, 1e-5;
granite-3-2b prefill in float32 for flash_attention, 2e-5; xDeepFM's
serve_bulk batch for embedding_bag, 1e-5; phase 5's, exact:
label_intersect on citeseer@1.0's labels from a host build at width 16, B =
2,293, 4,096 and 2^20 queries of phase 4's intersection residue;
frontier_or, fused, on the out-slab and first-wave frontier of citeseer@1.0
and of citeseer@0.5, built as ``chip_smoke.real_out_slab`` builds them;
flash_attention_bwd_sm90, K4's bf16 backward, at granite-3-2b's training
call and phase 3b's ``ATTENTION_BWD_CONFIGS``, each gradient within
``ATTENTION_BWD_TOL``, its device time the sum of its three kernels),
then at each shape all are timed by CUDA events, first to last and back,
twice, so every version sees the same card, and each one's kernel time is
read from torch.profiler (for label_intersect and frontier_or also with
the L2 flushed before every call, the time their shares of the DRAM-rate
bound are taken from); a call (the launch function, then a
synchronisation of the stream) is also timed on the host clock, its median
over 200.  Prints one JSON line per shape and source (its ptxas line, its
error, its four times in ms, its device ms, its call ms, the shape's bound
and the device time's share of it, label_intersect's gather floor and its
share), then the card's name and power limit.
``--bag-width D`` gives embedding_bag's table another row width with the
same ids.  Needs a CUDA card and ``nvcc``; the port never calls it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

REPS = {"bitset_mm": 20, "ell_spmm": 10, "flash_attention": 5, "embedding_bag": 50,
        "label_intersect": 200, "frontier_or": 200, "flash_attention_bwd_sm90": 10}
TIER_BATCHES = (2293, 4096, 1 << 20)   # phase 4h's median pinned residue, a batch, 2^20
SLAB_SCALES = (1.0, 0.5)
MAX_WAVE = 256   # the device build's wave size: 8 frontier words a row


def _build(src: pathlib.Path, out: pathlib.Path, include: pathlib.Path) -> str:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(include), "-o", str(out), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    return " ".join(line.split(":", 1)[-1].strip() for line in log.splitlines()
                    if "registers" in line)


def _arity(src: pathlib.Path, symbol: str) -> int:
    """The number of parameters of ``symbol``'s definition in ``src``."""
    found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src.read_text())
    if found is None:
        raise RuntimeError(f"{src} defines no {symbol}")
    return len(found.group(1).split(","))


def _library_inputs(kernel: str, device, bag_width=None):
    """(arguments of one launch but the stream, output, plain result,
    check(out, exp) -> max abs error, tensors to keep)."""
    import torch

    import chip_smoke as cs
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.reach import transitive_closure_bits
    from repro_torch.kernels import ref

    def close(rtol):
        def check(out, exp):
            cs.check(torch.allclose(out, exp, rtol=rtol, atol=rtol),
                     f"{kernel} differs from its plain version")
            return float((out - exp).abs().max())
        return check

    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    if kernel == "bitset_mm":
        bits = transitive_closure_bits(paper_dataset_analogue("human", scale=1.0))
        R = torch.from_numpy(bits.view(np.int32)).to(device)
        n, wm = R.shape
        out = torch.empty_like(R)
        exp = cs._rows_chunked(lambda sl: ref.bitset_mm_ref(R[sl], R), n, 256)

        def exact(out, exp):
            cs.check(torch.equal(out, exp), "bitset_mm differs from bitset_mm_ref")
            return 0
        return [R.data_ptr(), n, wm, R.data_ptr(), n, wm, out.data_ptr()], out, exp, exact, \
            (R,)
    if kernel == "ell_spmm":
        nbr, wgt, x, _ = cs.products_inputs(gen, device)
        (n, d), (n_src, F) = nbr.shape, x.shape
        out = torch.empty((n, F), dtype=torch.float32, device=device)
        flags = torch.zeros(1, dtype=torch.int32, device=device)
        exp = cs._rows_chunked(lambda sl: ref.ell_spmm_ref(nbr[sl], wgt[sl], x), n, 1 << 17)
        args = [nbr.data_ptr(), wgt.data_ptr(), n, d, x.data_ptr(), n_src, F, out.data_ptr(),
                flags.data_ptr()]
        return args, out, exp, close(1e-5), (nbr, wgt, x, flags)
    if kernel == "flash_attention":
        c = dict(cs.ATTENTION_CONFIGS)[
            "granite-3-2b prefill in float32 (configs/granite_3_2b.py, train_4k length)"]
        q = torch.randn((c["B"], c["Hq"], c["S"], c["D"]), generator=gen, device=device)
        k, v = (torch.randn((c["B"], c["Hkv"], c["T"], c["D"]), generator=gen, device=device)
                for _ in range(2))
        out = torch.empty_like(q)
        exp = cs._attention_plain_chunked(q, k, v, c["causal"], c["window"])

        def attention(out, exp):
            excess = cs._attention_excess(out, exp)
            cs.check(excess <= 1, f"flash_attention differs from its plain version: {excess}")
            return float((out - exp).abs().max())
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, c["B"], c["Hq"],
                c["Hkv"], c["S"], c["T"], c["T"], c["D"], c["D"], int(c["causal"]), 0, 0,
                1.0 / math.sqrt(c["D"])]
        return args, out, exp, attention, (q, k, v)
    table, idx = cs.xdeepfm_inputs(gen, device, bag_width)
    (V, D), (B, bag) = table.shape, idx.shape
    out = torch.empty((B, D), dtype=torch.float32, device=device)
    flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    exp = ref.embedding_bag_ref(table, idx)
    args = [table.data_ptr(), V, D, idx.data_ptr(), B, bag, out.data_ptr(), flag.data_ptr()]
    return args, out, exp, close(1e-5), (table, idx, flag)


def _tier_inputs(device) -> list:
    """K1's tier form at phase 5's shapes: citeseer@1.0's labels from a host
    build (``impl="auto"``), width 16, B of ``TIER_BATCHES`` queries of
    phase 4's intersection residue (repeated past its end)."""
    import torch

    import chip_smoke as cs
    from repro_torch.core.api import build_oracle
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.kernels import ref
    from repro_torch.serve.prefilter import apply_prefilters

    g = paper_dataset_analogue(cs.MAIN_DATASET, scale=cs.MAIN_SCALE)
    co = build_oracle(g, device=device)
    o, eng = co.oracle, co.engine
    cq = co.comp[cs.make_traffic(g, co, cs.MAIN_QUERIES)]
    rest = cq[~apply_prefilters(cq, o.out_len, o.in_len, eng.level).decided]
    L_out, L_in = o.device_labels(device)
    (n, Lo), Li, width = L_out.shape, L_in.shape[1], 16
    wa, wb = min(width, Lo), min(width, Li)

    def exact(out, exp):
        cs.check(torch.equal(out, exp), "label_intersect differs from tier_intersect_ref")
        return 0
    shapes = []
    for B in TIER_BATCHES:
        q = torch.from_numpy(np.resize(rest, (B, 2))).to(device)
        out = torch.empty(B, dtype=torch.uint8, device=device)
        exp = ref.tier_intersect_ref(L_out, L_in, q, width).to(torch.uint8)
        shapes.append({
            "shape": {"B": B, "width": width, "L_out": [n, Lo], "L_in": [n, Li]},
            "args": [L_out.data_ptr(), L_in.data_ptr(), n, Lo, Li, q.data_ptr(), B, wa, wb,
                     out.data_ptr()],
            "out": out, "exp": exp, "check": exact, "reset": out.zero_,
            "keep": (L_out, L_in, q), "bound": cs.tier_intersect_bound(L_out, L_in, q, width)})
    return shapes


def _slab_inputs(device) -> list:
    """K2's slab form, fused, on the out-slab and first-wave frontier of
    citeseer at each of ``SLAB_SCALES``, as phase 4b builds them
    (``chip_smoke.real_out_slab``, waves of at most 256 members)."""
    import torch

    import chip_smoke as cs
    from repro_torch.build.waves import wave_schedule
    from repro_torch.core.order import get_order
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.scc import condense_to_dag
    from repro_torch.kernels import ref

    shapes = []
    for scale in SLAB_SCALES:
        dag, _ = condense_to_dag(paper_dataset_analogue(cs.MAIN_DATASET, scale=scale))
        order = get_order(dag, "degree_product")
        waves = wave_schedule(dag, order, max_wave=MAX_WAVE)
        slab, f, perm = cs.real_out_slab(dag, order, waves, MAX_WAVE, device)
        (r, d), (n_src, wm) = slab.shape, f.shape
        out, flags = f.clone(), torch.zeros(2, dtype=torch.int32, device=device)
        exp_out, exp_flags = f.clone(), flags.clone()
        ref.frontier_or_ref(slab, f, out=exp_out, perm=perm, flags=exp_flags)

        def reset(out=out, flags=flags, f=f):
            out.copy_(f)
            flags.zero_()

        def exact(got, exp, flags=flags, exp_flags=exp_flags):
            cs.check(torch.equal(got, exp) and torch.equal(flags, exp_flags),
                     "frontier_or differs from frontier_or_ref")
            return 0
        shapes.append({
            "shape": {"scale": scale, "r": r, "d": d, "n_src": n_src, "wm": wm,
                      "valid_slots": int(slab.ne(-1).sum()), "form": "fused"},
            "args": [slab.data_ptr(), r, d, f.data_ptr(), n_src, wm, out.data_ptr(), n_src,
                     perm.data_ptr(), flags.data_ptr()],
            "out": out, "exp": exp_out, "check": exact, "reset": reset,
            "keep": (slab, f, perm, flags), "bound": cs.frontier_or_bound(slab, wm)})
    return shapes


def _attention_bwd_inputs(device) -> list:
    """K4's bf16 backward at granite-3-2b's training call (4 x 1,024, 32/8
    heads of 64, causal) and at phase 3b's ``ATTENTION_BWD_CONFIGS``: inputs
    from a seed, the forward's output and lse through this checkout's K4."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    configs = [("granite-3-2b training call", dict(B=4, Hq=32, Hkv=8, S=1024, T=1024, D=64,
                                                    Dv=64))] + cs.ATTENTION_BWD_CONFIGS
    shapes = []
    for label, c in configs:
        B, Hq, Hkv, S, T, D, Dv = (c[k] for k in ("B", "Hq", "Hkv", "S", "T", "D", "Dv"))
        q, k, v, do = (torch.randn(sh, generator=gen, device=device, dtype=torch.bfloat16)
                       for sh in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv),
                                  (B, Hq, S, Dv)))
        o, lse = ops._flash_attention(q, k, v, True, None, 1.0 / math.sqrt(D), T,
                                      return_lse=True)
        delta = torch.empty_like(lse)
        dq_acc = torch.empty((B, Hq, S, D), dtype=torch.float32, device=device)
        out = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        exp = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=True)

        def check(got, exp):
            excess = max(cs._bwd_excess(g, e) for g, e in zip(got, exp))
            cs.check(excess <= 1, f"flash_attention_bwd_sm90 differs from its plain version: "
                                  f"{excess} x ATTENTION_BWD_TOL")
            return max(float((g.float() - e.float()).abs().max()) for g, e in zip(got, exp))

        def reset(out=out):
            for t in out:
                t.zero_()
        flops = 2 * cs._attention_pairs(S, T, True, None) * (3 * D + 2 * Dv) * Hq * B
        shapes.append({
            "shape": {"config": label, **c},
            "args": [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
                     *(t.data_ptr() for t in out), B, Hq, Hkv, S, T, D, Dv, 1, 0, 0,
                     1.0 / math.sqrt(D)],
            "out": out, "exp": exp, "check": check, "reset": reset,
            "keep": (q, k, v, do, o, lse, delta, dq_acc), "bound": None,
            "operations_bound_ms": flops / cs.PEAK_BF16_FLOPS_PER_S * 1e3})
    return shapes


def _inputs(kernel: str, device, bag_width=None) -> list:
    """One dict a shape: the arguments of one launch but the stream, the
    output, the plain result, check(out, exp) -> max abs error, reset() of
    the output before a check, tensors to keep and, for the kernels of the
    oracle's paths, the shape and its bound."""
    if kernel == "label_intersect":
        return _tier_inputs(device)
    if kernel == "frontier_or":
        return _slab_inputs(device)
    if kernel == "flash_attention_bwd_sm90":
        return _attention_bwd_inputs(device)
    args, out, exp, check, keep = _library_inputs(kernel, device, bag_width)
    return [{"shape": None, "args": args, "out": out, "exp": exp, "check": check,
             "reset": out.zero_, "keep": keep, "bound": None}]


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.build import SIGNATURES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(REPS))
    ap.add_argument("sources", nargs="+", type=pathlib.Path)
    ap.add_argument("--bag-width", type=int, default=None,
                    help="embedding_bag's table row width (default: xDeepFM's 10)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    symbol, argtypes, restype = SIGNATURES[args.kernel]
    with tempfile.TemporaryDirectory() as tmp:
        srcs = []
        for i, src in enumerate(args.sources):
            srcs.append(pathlib.Path(tmp) / f"v{i}_{src.name}")
            shutil.copy(src, srcs[-1])
        with ThreadPoolExecutor(len(srcs)) as pool:
            ptxas = list(pool.map(lambda s: _build(s[1], s[1].with_suffix(".so"),
                                                   s[0].resolve().parent),
                                  zip(args.sources, srcs)))
        libs = [ctypes.CDLL(str(s.with_suffix(".so"))) for s in srcs]
    stream = torch.cuda.current_stream(device)
    # a call launches one of these kernels
    symbols = cs.ATTENTION_SYMBOLS.get(args.kernel, f"{args.kernel}_kernel")
    reps = REPS[args.kernel]
    flush = cs._l2_flush(device)

    def call(launch):
        rc = launch()
        cs.check(rc == 0, f"launch failed: CUDA error {rc}")

    def call_ms(launch) -> list:
        ts = []
        for _ in range(200):
            t0 = time.perf_counter()
            call(launch)
            stream.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return ts

    for shape in _inputs(args.kernel, device, args.bag_width):
        launches = []
        for src, lib in zip(args.sources, libs):
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, restype
            full = shape["args"]
            if _arity(src, symbol) == len(argtypes) + 1:   # a device flag word before the last
                d_flag = torch.zeros(1, dtype=torch.int32, device=device)
                shape["keep"] += (d_flag,)
                fn.argtypes = argtypes[:-2] + [ctypes.c_void_p] + argtypes[-2:]
                full = full[:-1] + [d_flag.data_ptr()] + full[-1:]
            elif args.kernel == "flash_attention" and _arity(src, symbol) < len(argtypes):
                # a source from before the lse pointer (the argument after out), one
                # fewer from before Dv (the argument after D), one fewer again from
                # before kv_len (the argument after T)
                drop = set((4, 12, 10)[:len(argtypes) - _arity(src, symbol)])
                fn.argtypes = [a for i, a in enumerate(argtypes) if i not in drop]
                full = [a for i, a in enumerate(full) if i not in drop]
            launches.append(lambda fn=fn, full=full: fn(*full, stream.cuda_stream))
        errors = []
        for launch in launches:
            shape["reset"]()
            call(launch)
            torch.cuda.synchronize()
            errors.append(shape["check"](shape["out"], shape["exp"]))
        order = list(range(len(launches)))
        times = [[] for _ in order]
        calls = [[] for _ in order]
        for i in (order + order[::-1]) * 2:
            times[i].append(cs._event_ms(lambda: call(launches[i]), reps, warmup=2))
            calls[i] += (call_ms(launches[i])
                         if args.kernel in ("embedding_bag", "label_intersect") else [])
        if args.kernel == "flash_attention_bwd_sm90":   # a call launches three kernels
            device_ms = [sum(cs._each_kernel_device_ms(
                lambda: call(launch), cs.ATTENTION_BWD_SYMBOLS["bfloat16"], 50).values())
                for launch in launches]
        else:
            device_ms = [cs._kernel_device_ms(lambda: call(launch), symbols, min(reps, 50))
                         for launch in launches]
        bound = shape["bound"] or {}
        cold_ms = [cs._cold_device_ms(lambda: call(launch), symbols, min(reps, 50), flush)
                   for launch in launches] if bound else [None] * len(launches)
        for src, regs, err, ms, dev_ms, cold, cm in zip(args.sources, ptxas, errors, times,
                                                        device_ms, cold_ms, calls):
            line = {"kernel": args.kernel, "source": str(src), "shape": shape["shape"],
                    "ptxas": regs, "max_abs_err": err, "ms": min(ms), "ms_runs": ms,
                    "device_ms": dev_ms, "call_ms": float(np.median(cm)) if cm else None}
            if bound:
                line.update({"device_ms_l2_flushed": cold, "bound_ms": bound["bound_ms"],
                             "bound_by": bound["bound_by"], "bytes": bound["bytes"],
                             "bound_share": bound["bound_ms"] / cold,
                             "bound_share_l2_warm": bound["bound_ms"] / dev_ms})
            if "operations_bound_ms" in shape:
                line.update({"bound_ms": shape["operations_bound_ms"],
                             "bound_by": "operations",
                             "bound_share": shape["operations_bound_ms"] / dev_ms})
            if "gather_floor_ms" in bound:
                line.update({"gather_floor_bytes": bound["gather_floor_bytes"],
                             "gather_floor_share": bound["gather_floor_ms"] / cold})
            print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
