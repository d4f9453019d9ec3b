"""Time versions of one of the port's CUDA kernels on one card, in turns.

    python3 tools/kernel_ab.py {bitset_mm,ell_spmm,ell_spmm_bwd,flash_attention,
                                embedding_bag,label_intersect,frontier_or,
                                flash_attention_bwd,flash_attention_bwd_sm90}
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
granite-3-2b prefill in float32 for flash_attention, 2e-5, and phase 4l
(g)'s three danube decodes and a deepseek-7b decode step (the short-row
kernel: a source given a workspace and ``ops.attention_split_plan``'s
pieces, a source from before them neither; the device time of a call the
sum of its kernels, the first design's short-row kernel among them, each
with its bound and its time after an L2 flush); xDeepFM's
serve_bulk batch for embedding_bag, 1e-5; phase 5's, exact:
label_intersect on citeseer@1.0's labels from a host build at width 16, B =
2,293, 4,096 and 2^20 queries of phase 4's intersection residue;
frontier_or, fused, on the out-slab and first-wave frontier of citeseer@1.0
and of citeseer@0.5, built as ``chip_smoke.real_out_slab`` builds them;
flash_attention_bwd_sm90, K4's bf16 backward, at granite-3-2b's training
call and phase 3b's ``ATTENTION_BWD_CONFIGS``, each gradient within
``ATTENTION_BWD_TOL``, its device time the sum of its three kernels;
flash_attention_bwd, K4's float32 backward, at the same shapes in float32
(each source given its own copy of the forward's lse, which the first
design of the source overwrote with its own), its device time the sum of its kernels;
ell_spmm at ogb_products' rows with F = 100, 16 and 7 (GCN's widths),
ell_spmm_bwd at phase 4k's call, K5 over the transposed rows of GCN's
training graph, both within 1e-5; K5's bad-id flag is a pinned host word
for a source that maps one (``cudaHostGetDevicePointer``), else a device
word, and its call time is its wrapper's work: clear the flag, launch,
synchronise, read it),
then at each shape all are timed by CUDA events, first to last and back,
twice, so every version sees the same card, and each one's kernel time is
read from torch.profiler (for label_intersect and frontier_or also with
the L2 flushed before every call, the time their shares of the DRAM-rate
bound are taken from); a call (the launch function, then a
synchronisation of the stream; K5's as its wrapper makes it) is also timed on
the host clock, its median over 200.  Prints one JSON line per shape and source (its ptxas line, its
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

REPS = {"bitset_mm": 20, "ell_spmm": 10, "ell_spmm_bwd": 200, "flash_attention": 5,
        "embedding_bag": 50, "label_intersect": 200, "frontier_or": 200,
        "flash_attention_bwd": 3, "flash_attention_bwd_sm90": 10}
# the kernel whose launch function each name times, where it is another's
SYMBOL_OF = {"ell_spmm_bwd": "ell_spmm"}
SPMM_WIDTHS = (100, 16, 7)   # ogb_products' F, then GCN's hidden and output widths
BWD_PATTERN = r"attention_bwd_\w*kernel"   # every kernel of a K4 backward call
# K4's float32 short-row kernel of the design before its pieces and merge
FIRST_SHORT_ROW = ("flash_attention_kernel",)
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
    table, idx = cs.xdeepfm_inputs(gen, device, bag_width)
    (V, D), (B, bag) = table.shape, idx.shape
    out = torch.empty((B, D), dtype=torch.float32, device=device)
    flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    exp = ref.embedding_bag_ref(table, idx)
    args = [table.data_ptr(), V, D, idx.data_ptr(), B, bag, out.data_ptr(), flag.data_ptr()]
    return args, out, exp, close(1e-5), (table, idx, flag)


def _attention_inputs(device) -> list:
    """K4 in float32: granite-3-2b's prefill (the tiled kernel), phase 4l
    (g)'s three danube decodes over a rank's 4,096-key block (32 q heads
    over 8 kv heads of 80: the whole block, a window of 2,287, a window of
    one key over a prefix of 4,000) and one deepseek-7b decode step (phase
    4j's: batch 8, 32 heads of 128, rep 1, kv_len 4,161 of a 4,176 cache,
    NaN past it), each within 2e-5 of the plain version; the decodes on the
    short-row kernel, given the workspace and pieces of
    ``ops.attention_split_plan``, each shape with its bound."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    granite = dict(cs.ATTENTION_CONFIGS)[
        "granite-3-2b prefill in float32 (configs/granite_3_2b.py, train_4k length)"]
    danube = dict(B=1, Hq=32, Hkv=8, S=1, T=4096, D=80, causal=True, dtype="float32")
    configs = [dict(granite, dtype="float32")] + [
        dict(danube, window=w, kv_len=n) for w, n in ((None, 4096), (2287, 4096), (1, 4000))
    ] + [dict(B=8, Hq=32, Hkv=32, S=1, T=4176, kv_len=4161, D=128, causal=True, window=None,
              dtype="float32")]

    def attention(out, exp):
        excess = cs._attention_excess(out, exp)
        cs.check(excess <= 1, f"flash_attention differs from its plain version: {excess}")
        return float((out - exp).abs().max())
    shapes = []
    for c in configs:
        B, Hq, Hkv, S, T, D = (c[k] for k in ("B", "Hq", "Hkv", "S", "T", "D"))
        kv_len = c.get("kv_len") or T
        q = torch.randn((B, Hq, S, D), generator=gen, device=device)
        k, v = (torch.randn((B, Hkv, T, D), generator=gen, device=device) for _ in range(2))
        k[:, :, kv_len:], v[:, :, kv_len:] = math.nan, math.nan
        out = torch.empty_like(q)
        exp = (cs._attention_plain_chunked(q, k, v, c["causal"], c["window"]) if S > 1 else
               ref.flash_attention_ref(q, k, v, causal=c["causal"], window=c["window"],
                                       kv_len=kv_len))
        splits = ops.attention_split_plan(B, Hkv, Hq // Hkv, S, kv_len, c["causal"],
                                          c["window"], ops._sm_count(device))
        work = torch.empty(B * Hq * S * splits * (D + 2), device=device)
        window = c["window"]
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, Hq, Hkv, S,
                T, kv_len, D, D, int(c["causal"]), window is not None, window or 0,
                1.0 / math.sqrt(D), work.data_ptr() if splits > 1 else None, splits]
        shapes.append({"shape": {**c, "splits": splits}, "args": args, "out": out, "exp": exp,
                       "check": attention, "reset": out.zero_, "keep": (q, k, v, work),
                       "bound": cs.attention_bound(c), "reps": 50 if S == 1 else None})
    return shapes


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


def _spmm_shape(label: str, nbr, wgt, x, exp) -> dict:
    """A K5 shape: its launch's arguments but the flag word (``None`` in its
    place, chosen for each source), the byte bound and the gather floor."""
    import torch

    import chip_smoke as cs

    (n, d), (n_src, F) = nbr.shape, x.shape
    valid = int(nbr.ge(0).sum())
    out = torch.empty((n, F), dtype=torch.float32, device=x.device)

    def check(got, exp):
        cs.check(torch.allclose(got, exp, rtol=1e-5, atol=1e-5),
                 "ell_spmm differs from its plain version")
        return float((got - exp).abs().max())
    ids_out = n * d * 8 + n * F * 4   # ids and weights read, out written
    floor_ms = (ids_out + valid * F * 4) / cs.PEAK_BYTES_PER_S * 1e3
    return {"shape": {"config": label, "n": n, "d": d, "n_src": n_src, "F": F,
                      "valid_slots": valid},
            "args": [nbr.data_ptr(), wgt.data_ptr(), n, d, x.data_ptr(), n_src, F,
                     out.data_ptr(), None],
            "out": out, "exp": exp, "check": check, "reset": out.zero_, "keep": (nbr, wgt, x),
            "bound": None, "flag_word": True,
            "line": {**cs._bound(ids_out + n_src * F * 4, 2 * valid * F, cs.PEAK_F32_FLOPS_PER_S),
                     "gather_floor_ms": floor_ms}}


def _spmm_inputs(device) -> list:
    """K5 over ogb_products' rows (phase 3b's) at ``SPMM_WIDTHS``."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    nbr, wgt, x, _ = cs.products_inputs(gen, device)
    shapes = []
    for F in SPMM_WIDTHS:
        xf = x[:, :F].contiguous()
        exp = cs._rows_chunked(lambda sl: ref.ell_spmm_ref(nbr[sl], wgt[sl], xf), nbr.shape[0],
                               1 << 17)
        shapes.append(_spmm_shape(f"ogb_products rows, F = {F}", nbr, wgt, xf, exp))
    return shapes


def _spmm_bwd_inputs(device) -> list:
    """K5 over the transposed rows at phase 4k's call: GCN's first layer's
    backward on launch.train's graph at ``TRAIN_GCN_NODES``, captured from one
    step's gradients."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    argv = ["--arch", "gcn-cora", "--gnn-nodes", str(cs.TRAIN_GCN_NODES), "--device",
            str(device)]
    _, params, loss_of, _, _ = train.setup(train.parse_args(argv))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    with cs._LastCall("_ell_spmm", lambda a: a[3:] == ("ell_spmm_bwd",)) as cap:
        torch.autograd.grad(loss_of(params, None), leaves, allow_unused=True)
    (nbr_t, wgt_t, dout, _), _, _ = cap.last
    exp = ref.ell_spmm_ref(nbr_t, wgt_t, dout)
    return [_spmm_shape(f"GCN training's first layer's backward, random_dag("
                        f"{cs.TRAIN_GCN_NODES}, {3 * cs.TRAIN_GCN_NODES}) (phase 4k)",
                        nbr_t, wgt_t, dout, exp)]


def _attention_f32_bwd_inputs(device) -> list:
    """K4's float32 backward at granite-3-2b's training call (4 x 1,024,
    32/8 heads of 64, causal) and at phase 3b's ``ATTENTION_BWD_CONFIGS``:
    inputs from a seed, the forward's output and lse through this checkout's
    K4; a source gets its own copy of lse (``per_source``)."""
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
        q, k, v, do = (torch.randn(sh, generator=gen, device=device)
                       for sh in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv),
                                  (B, Hq, S, Dv)))
        o, lse = ops._flash_attention(q, k, v, True, None, 1.0 / math.sqrt(D), T,
                                      return_lse=True)
        delta = torch.empty_like(lse)
        out = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        exp = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=True)

        def check(got, exp):
            excess = max(cs._bwd_excess(g, e) for g, e in zip(got, exp))
            cs.check(excess <= 1, f"flash_attention_bwd differs from its plain version: "
                                  f"{excess} x ATTENTION_BWD_TOL")
            return max(float((g - e).abs().max()) for g, e in zip(got, exp))

        def reset(out=out):
            for t in out:
                t.zero_()

        def per_source(args, lse=lse):
            mine = lse.clone()
            return args[:8] + [mine.data_ptr()] + args[9:], mine
        flops = 2 * cs._attention_pairs(S, T, True, None) * (3 * D + 2 * Dv) * Hq * B
        shapes.append({
            "shape": {"config": label, **c, "dtype": "float32"},
            "args": [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     *(t.data_ptr() for t in out), lse.data_ptr(), delta.data_ptr(), B, Hq, Hkv,
                     S, T, D, Dv, 1, 0, 0, 1.0 / math.sqrt(D)],
            "out": out, "exp": exp, "check": check, "reset": reset, "per_source": per_source,
            "keep": (q, k, v, do, o, lse, delta), "bound": None,
            "operations_bound_ms": flops / cs.PEAK_F32_FLOPS_PER_S * 1e3})
    return shapes


def _pattern_device_ms(fn, pattern: str, calls: int) -> float:
    """torch.profiler's device time of one call of ``fn``: the kernels whose
    names match ``pattern`` over ``calls`` calls, summed, over ``calls``."""
    import chip_smoke as cs

    _, events = cs._device_events(lambda: [fn() for _ in range(calls)])
    times = [us for cat, name, us in events if cat == "kernel" and re.search(pattern, name)]
    cs.check(bool(times), f"torch.profiler recorded no kernel matching {pattern}")
    return sum(times) / calls / 1e3


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
    if kernel == "flash_attention_bwd":
        return _attention_f32_bwd_inputs(device)
    if kernel == "ell_spmm":
        return _spmm_inputs(device)
    if kernel == "flash_attention":
        return _attention_inputs(device)
    if kernel == "ell_spmm_bwd":
        return _spmm_bwd_inputs(device)
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
    symbol, argtypes, restype = SIGNATURES[SYMBOL_OF.get(args.kernel, args.kernel)]
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
    symbols = (cs.SPMM_SYMBOLS if args.kernel in ("ell_spmm", "ell_spmm_bwd") else
               cs.ATTENTION_SYMBOLS.get(args.kernel, f"{args.kernel}_kernel"))
    if args.kernel == "flash_attention":   # and the short-row kernel of the first design
        symbols += FIRST_SHORT_ROW
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
        reps = shape.get("reps") or REPS[args.kernel]
        launches, wrapped = [], []
        for src, lib in zip(args.sources, libs):
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, restype
            full = shape["args"]
            if "per_source" in shape:
                full, mine = shape["per_source"](full)
                shape["keep"] += (mine,)
            if shape.get("flag_word"):   # K5: a pinned host word it maps, else a device word
                if "cudaHostGetDevicePointer" in src.read_text():
                    flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
                    flag_np = flag.numpy()

                    def clear(flag_np=flag_np):
                        flag_np[0] = 0

                    def read(flag_np=flag_np):
                        stream.synchronize()
                        return int(flag_np[0])
                else:
                    flag = torch.zeros(1, dtype=torch.int32, device=device)
                    clear, read = flag.zero_, lambda flag=flag: int(flag[0])
                shape["keep"] += (flag,)
                full = full[:-1] + [flag.data_ptr()]
                launch = lambda fn=fn, full=full: fn(*full, stream.cuda_stream)  # noqa: E731

                def as_wrapper(launch=launch, clear=clear, read=read):
                    clear()
                    rc = launch()
                    cs.check(read() == 0, "ell_spmm flagged a bad id")
                    return rc
                wrapped.append(as_wrapper)
            elif _arity(src, symbol) == len(argtypes) + 1:   # a device flag word before the last
                d_flag = torch.zeros(1, dtype=torch.int32, device=device)
                shape["keep"] += (d_flag,)
                fn.argtypes = argtypes[:-2] + [ctypes.c_void_p] + argtypes[-2:]
                full = full[:-1] + [d_flag.data_ptr()] + full[-1:]
            elif args.kernel == "flash_attention" and _arity(src, symbol) < len(argtypes):
                # a source from before the workspace and its pieces (the two arguments
                # after scale), one fewer from before the lse pointer (the argument
                # after out), one fewer again from before Dv (the argument after D),
                # one fewer again from before kv_len (the argument after T)
                drop = set((17, 18, 4, 12, 10)[:len(argtypes) - _arity(src, symbol)])
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
            if wrapped:
                calls[i] += call_ms(wrapped[i])
            elif args.kernel in ("embedding_bag", "label_intersect"):
                calls[i] += call_ms(launches[i])
        if args.kernel == "flash_attention_bwd_sm90":   # a call launches three kernels
            device_ms = [sum(cs._each_kernel_device_ms(
                lambda: call(launch), cs.ATTENTION_BWD_SYMBOLS["bfloat16"], 50).values())
                for launch in launches]
        elif args.kernel == "flash_attention_bwd":   # each design's kernels, summed
            device_ms = [_pattern_device_ms(lambda: call(launch), BWD_PATTERN, 10)
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
            if "line" in shape:   # K5: its bound and gather floor, shares of the device time
                line.update({k: shape["line"][k] for k in ("bound_ms", "bound_by", "bytes",
                                                           "gather_floor_ms")},
                            bound_share=shape["line"]["bound_ms"] / dev_ms,
                            gather_floor_share=shape["line"]["gather_floor_ms"] / dev_ms)
            if "gather_floor_ms" in bound:
                line.update({"gather_floor_bytes": bound["gather_floor_bytes"],
                             "gather_floor_share": bound["gather_floor_ms"] / cold})
            print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
