"""Time versions of one of the port's CUDA kernels on one card, in turns.

    python3 tools/kernel_ab.py {bitset_mm,ell_spmm,flash_attention,embedding_bag} \
        SOURCE.cu [SOURCE.cu ...]

Each SOURCE exports the launch function that ``kernels/build.py``'s
``SIGNATURES`` gives the kernel: this checkout's ``csrc/<kernel>.cu``, an
earlier one (``git show <commit>:src/repro_torch/kernels/csrc/<kernel>.cu``)
or a candidate design.  ``embedding_bag``'s flag is a word of pinned host
memory, which sources from before it moved there write through its
mapping as they wrote a device word (only on a bad id); a source whose
launch function takes one more parameter is given a device flag word
before it (cleared and copied back by the launch function).  All are
compiled at once with build.py's ``nvcc`` flags and loaded with ctypes;
each is held against the kernel's plain version at ``chip_smoke.py``'s
phase 3b shape (the closure step of the "human" analogue for bitset_mm,
exact; ogb_products for ell_spmm, 1e-5; granite-3-2b prefill in float32
for flash_attention, 2e-5; xDeepFM's serve_bulk batch for embedding_bag,
1e-5), then all are timed by CUDA events, first to last and back, twice, so
every version sees the same card, and each one's kernel time is read from
torch.profiler; a call (the launch function, then a synchronisation of the
stream) is also timed on the host clock, its median over 200.  Prints one
JSON line per source (its ptxas line, its error, its four times in ms, its
device ms, its call ms), then the card's name and power limit.
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

REPS = {"bitset_mm": 20, "ell_spmm": 10, "flash_attention": 5, "embedding_bag": 50}


def _build(src: pathlib.Path, out: pathlib.Path) -> str:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
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


def _inputs(kernel: str, device, bag_width=None):
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
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), c["B"], c["Hq"],
                c["Hkv"], c["S"], c["T"], c["D"], int(c["causal"]), 0, 0,
                1.0 / math.sqrt(c["D"])]
        return args, out, exp, attention, (q, k, v)
    table, idx = cs.xdeepfm_inputs(gen, device, bag_width)
    (V, D), (B, bag) = table.shape, idx.shape
    out = torch.empty((B, D), dtype=torch.float32, device=device)
    flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    exp = ref.embedding_bag_ref(table, idx)
    args = [table.data_ptr(), V, D, idx.data_ptr(), B, bag, out.data_ptr(), flag.data_ptr()]
    return args, out, exp, close(1e-5), (table, idx, flag)


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
            ptxas = list(pool.map(lambda s: _build(s, s.with_suffix(".so")), srcs))
        libs = [ctypes.CDLL(str(s.with_suffix(".so"))) for s in srcs]
    launch_args, out, exp, check_out, keep = _inputs(args.kernel, device, args.bag_width)
    launches = []
    for src, lib in zip(args.sources, libs):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
        full = launch_args
        if _arity(src, symbol) == len(argtypes) + 1:   # a device flag word before the last
            d_flag = torch.zeros(1, dtype=torch.int32, device=device)
            keep += (d_flag,)
            fn.argtypes = argtypes[:-2] + [ctypes.c_void_p] + argtypes[-2:]
            full = launch_args[:-1] + [d_flag.data_ptr()] + launch_args[-1:]
        launches.append(lambda fn=fn, full=full: fn(
            *full, torch.cuda.current_stream(device).cuda_stream))

    def call(launch):
        rc = launch()
        cs.check(rc == 0, f"launch failed: CUDA error {rc}")

    errors = []
    for src, launch in zip(args.sources, launches):
        out.zero_()
        call(launch)
        torch.cuda.synchronize()
        errors.append(check_out(out, exp))
    stream = torch.cuda.current_stream(device)

    def call_ms(launch) -> list:
        ts = []
        for _ in range(200):
            t0 = time.perf_counter()
            call(launch)
            stream.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return ts

    order = list(range(len(launches)))
    times = [[] for _ in order]
    calls = [[] for _ in order]
    for i in (order + order[::-1]) * 2:
        times[i].append(cs._event_ms(lambda: call(launches[i]), REPS[args.kernel], warmup=2))
        calls[i] += call_ms(launches[i]) if args.kernel == "embedding_bag" else []
    # a call launches one of these kernels
    symbols = cs.ATTENTION_SYMBOLS.get(args.kernel, f"{args.kernel}_kernel")
    device_ms = [cs._kernel_device_ms(lambda: call(launch), symbols, REPS[args.kernel])
                 for launch in launches]
    for src, regs, err, ms, dev_ms, cm in zip(args.sources, ptxas, errors, times, device_ms,
                                              calls):
        print(json.dumps({"kernel": args.kernel, "source": str(src), "ptxas": regs,
                          "max_abs_err": err, "ms": min(ms), "ms_runs": ms,
                          "device_ms": dev_ms,
                          "call_ms": float(np.median(cm)) if cm else None}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
