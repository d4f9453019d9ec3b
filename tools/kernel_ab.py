"""Time versions of one of the port's CUDA kernels on one card, in turns.

    python3 tools/kernel_ab.py {bitset_mm,ell_spmm} SOURCE.cu [SOURCE.cu ...]

Each SOURCE exports the launch function that ``kernels/build.py``'s
``SIGNATURES`` gives the kernel: this checkout's ``csrc/<kernel>.cu``, an
earlier one (``git show <commit>:src/repro_torch/kernels/csrc/<kernel>.cu``)
or a candidate design.  All are compiled at once with build.py's ``nvcc``
flags and loaded with ctypes; each is held against the kernel's plain
version at ``chip_smoke.py``'s phase 3b shape (the closure step of the
"human" analogue for bitset_mm, exact; ogb_products for ell_spmm, 1e-5),
then all are timed by CUDA events, first to last and back, twice, so every
version sees the same card.  Prints one JSON line per source (its ptxas
line, its error, its four times in ms), then the card's name and power
limit.  Needs a CUDA card and ``nvcc``; the port never calls it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

REPS = {"bitset_mm": 20, "ell_spmm": 10}


def _build(src: pathlib.Path, out: pathlib.Path) -> str:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    return " ".join(line.split(":", 1)[-1].strip() for line in log.splitlines()
                    if "registers" in line)


def _inputs(kernel: str, device):
    """(arguments of one launch but the stream, output, plain result)."""
    import torch

    import chip_smoke as cs
    from repro_torch.graph.generators import paper_dataset_analogue
    from repro_torch.graph.reach import transitive_closure_bits
    from repro_torch.kernels import ref

    if kernel == "bitset_mm":
        bits = transitive_closure_bits(paper_dataset_analogue("human", scale=1.0))
        R = torch.from_numpy(bits.view(np.int32)).to(device)
        n, wm = R.shape
        out = torch.empty_like(R)
        exp = cs._rows_chunked(lambda sl: ref.bitset_mm_ref(R[sl], R), n, 256)
        args = [R.data_ptr(), n, wm, R.data_ptr(), n, wm, out.data_ptr()]
        return args, out, exp, (R,)
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    nbr, wgt, x, _ = cs.products_inputs(gen, device)
    (n, d), (n_src, F) = nbr.shape, x.shape
    out = torch.empty((n, F), dtype=torch.float32, device=device)
    flags = torch.zeros(1, dtype=torch.int32, device=device)
    exp = cs._rows_chunked(lambda sl: ref.ell_spmm_ref(nbr[sl], wgt[sl], x), n, 1 << 17)
    args = [nbr.data_ptr(), wgt.data_ptr(), n, d, x.data_ptr(), n_src, F, out.data_ptr(),
            flags.data_ptr()]
    return args, out, exp, (nbr, wgt, x, flags)


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.build import SIGNATURES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(REPS))
    ap.add_argument("sources", nargs="+", type=pathlib.Path)
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
    launches = []
    for lib in libs:
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
        launches.append(fn)
    launch_args, out, exp, _keep = _inputs(args.kernel, device)

    def call(fn):
        rc = fn(*launch_args, torch.cuda.current_stream(device).cuda_stream)
        cs.check(rc == 0, f"launch failed: CUDA error {rc}")

    errors = []
    for src, fn in zip(args.sources, launches):
        out.zero_()
        call(fn)
        torch.cuda.synchronize()
        if args.kernel == "bitset_mm":
            cs.check(torch.equal(out, exp), f"{src} differs from bitset_mm_ref")
            errors.append(0)
        else:
            cs.check(torch.allclose(out, exp, rtol=1e-5, atol=1e-5),
                     f"{src} differs from ell_spmm_ref")
            errors.append(float((out - exp).abs().max()))
    order = list(range(len(launches)))
    times = [[] for _ in order]
    for i in (order + order[::-1]) * 2:
        times[i].append(cs._event_ms(lambda: call(launches[i]), REPS[args.kernel], warmup=2))
    for src, regs, err, ms in zip(args.sources, ptxas, errors, times):
        print(json.dumps({"kernel": args.kernel, "source": str(src), "ptxas": regs,
                          "max_abs_err": err, "ms": min(ms), "ms_runs": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
