"""The head of the device build: Distribution-Labeling's first iterations,
from empty labels, again and again.

Set-up makes the deployment's graph on the card (its structure fixed by
the configuration, its numbering drawn from the seed: ``gen.relabeled_graph``)
and the first ``prefix`` vertices of the §5.2 order, binds the program's
one-rank ``distribute_one`` (``make_sharded_distribute_one(None, ...)``, the
program the ``build_sweep`` cells of ``repro_torch.configs.reachability``
run; not ``build_oracle``'s wave build) and runs one iteration to warm up.  The window runs whole prefixes,
each from a fresh ``init_state``, one synchronised call an iteration.  The
state the last prefix leaves is compared, entry for entry, with the plain
reference's once the window has closed.

Traffic keys: ``prefix``.  Configuration keys: ``n``, ``l_max``,
``max_steps`` and the graph's (``gen.structure``).
"""
from __future__ import annotations

import gc
import sys
import time
import types

import torch

from bench import gen, reference

FIELDS = ("L_out", "L_in", "out_len", "in_len", "overflow")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(config: dict, traffic: dict, seed: int, device, program: bool = True):
    """The inputs, and with ``program`` the bound iteration, warmed up."""
    n, k = config["n"], traffic["prefix"]
    t0 = time.perf_counter()
    src, dst, order = gen.relabeled_graph(config, seed, k, device)
    _sync(device)
    log = {"graph_s": time.perf_counter() - t0}
    state = types.SimpleNamespace(device=device, config=config, src=src, dst=dst,
                                  order=order, final=None)
    if program:
        from repro_torch.core.distribution_device import (init_state,
                                                          make_sharded_distribute_one)

        state.init = lambda: init_state(n, config["l_max"], device)
        state.fn = make_sharded_distribute_one(None, n, config["max_steps"], "gather")
        state.vis = [order[j].to(torch.int32) for j in range(k)]
        t0 = time.perf_counter()
        warm = state.fn(state.init(), state.vis[0], src, dst, dst, src)
        _sync(device)
        del warm
        log["warm_s"] = time.perf_counter() - t0
    print(f"build_prefix set-up: {log}", file=sys.stderr)
    return state


def window(state, seconds: float, mark) -> dict:
    """Whole prefixes until ``seconds`` have passed."""
    fn, src, dst, dev = state.fn, state.src, state.dst, state.device
    calls = []
    t_start = t1 = time.perf_counter()
    while t1 - t_start < seconds:
        state.final = None     # the last prefix's state goes before the next is made
        st = state.init()
        for vi in state.vis:
            t0 = time.perf_counter()
            with mark("distribute_one"):
                st = fn(st, vi, src, dst, dst, src)
                _sync(dev)
            t1 = time.perf_counter()
            calls.append(t1 - t0)
        state.final = st
    return {"seconds": t1 - t_start, "iterations": len(calls), "call_s": calls,
            "attempted": len(calls), "failed": 0}


def summary(window: dict) -> str:
    """The rate over each half of the window's calls and their median, for
    the log."""
    calls = window["call_s"]
    half = len(calls) // 2
    rates = [len(c) / sum(c) for c in (calls[:half], calls[half:]) if c]
    return (f"{window['iterations']} iterations in {window['seconds']:.3f} s; calls/s by half "
            f"{', '.join(f'{r:.4f}' for r in rates)}; median call "
            f"{1e3 * sorted(calls)[len(calls) // 2]:.3f} ms")


def control(state) -> None:
    """The reference in the program's place, each BFS one level short."""
    c = state.config
    state.final = types.SimpleNamespace(**reference.distribute(
        state.src, state.dst, state.order, c["n"], c["l_max"], c["max_steps"], short=True))


def check(state, trace: bool) -> tuple:
    """The label state the last prefix left against the reference's, every
    entry, length and the overflow flag; the program's objects are freed
    first."""
    for name in ("fn", "init", "vis"):
        state.__dict__.pop(name, None)
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    c = state.config
    want = reference.distribute(state.src, state.dst, state.order, c["n"], c["l_max"],
                                c["max_steps"])
    got = state.final
    differ = 0
    for name in FIELDS:
        a, b = getattr(got, name, None), want[name]
        if not isinstance(a, torch.Tensor) or a.shape != b.shape:
            differ += b.numel()
        else:
            differ += int((a.to(b.dtype) != b).sum())
    extra = {"labeled": int(want["out_len"].sum() + want["in_len"].sum())}
    return {"label_entries_differing": {"value": differ, "limit": 0}}, extra
