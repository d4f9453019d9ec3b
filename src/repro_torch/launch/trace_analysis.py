"""Roofline terms from a traced rank: the counterpart of
``repro.launch.hlo_analysis``.

JAX reads its numbers from the compiled, partitioned HLO of one device.
Torch has no partitioner: the port's dry run (``launch.dryrun``) runs one
rank's program on ``meta`` tensors and counts what it dispatches:

  compute term    = FLOPs / (chips * peak FLOPs)
  memory term     = bytes accessed / (chips * HBM bandwidth)
  collective term = collective bytes / (chips * link bandwidth)

Hardware model: NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU
datasheet: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3,
NVLink 4 at 900 GB/s a card, 450 GB/s each direction (one direction taken:
a collective's bytes leave a card one way).

FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s, counted by
``TraceCounter`` from the same formulas (the products and attention they
know; on the dry run's cells no op reaches ``FlopCounterMode`` undecomposed
but ``silu_backward``, which has none) plus what each kernel wrapper records on ``meta``
(``kernels.ops.META_COST``).  Bytes accessed are each dispatched op's input
and output bytes, counted once an op, as ``HloCostAnalysis`` counts an
instruction's operands and result (views, which move nothing, and
allocations are left out), plus the kernels' ``META_COST`` bytes.
Collective bytes are counted by ``CollectiveCounter``: each collective is
sized by the largest buffer it touches (an all-gather's gathered result, a
reduce-scatter's whole input, an all-reduce's tensor, an all-to-all's send
or receive buffer), per kind.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12       # dense bf16 per card
HBM_BW = 3.35e12          # bytes/s per card
LINK_BW = 450e9           # bytes/s per card, one direction of NVLink 4

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "broadcast")

# op name fragment -> kind; c10d's ops and the functional collectives'
_KINDS = (("allgather", "all-gather"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
          ("all_reduce", "all-reduce"), ("alltoall", "all-to-all"),
          ("all_to_all", "all-to-all"), ("broadcast", "broadcast"))

# allocations: no bytes move
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_kind(func) -> str | None:
    if getattr(func, "namespace", "") not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = func._overloadpacket.__name__ if hasattr(func, "_overloadpacket") else str(func)
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives a rank issues, as ``CommDebugMode``'s
    ``get_comm_counts`` does (by op), sums their bytes by kind and keeps
    them in the order the rank issued them.  A plain dispatch mode: it
    sees every op once and looks no further than its namespace, where
    ``CommDebugMode`` tracks modules and DTensor calls at each op."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.order = []
        self.counts = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = collective_kind(func)
        if kind is not None:
            leaves, _ = tree_flatten((args, kwargs or {}))
            b = max((_bytes(x) for x in leaves if isinstance(x, torch.Tensor)), default=0)
            self.bytes[kind] += b
            self.order.append((kind, b))
            self.counts[func._overloadpacket] += 1
        return func(*args, **(kwargs or {}))

    def get_comm_counts(self) -> dict:
        return dict(self.counts)

    def summary(self) -> Dict[str, int]:
        out = dict(self.bytes)
        out["count"] = len(self.order)
        out["total"] = sum(self.bytes.values())
        return out


class TraceCounter(TorchDispatchMode):
    """FLOPs (``FlopCounterMode``'s: the formulas of
    ``torch.utils.flop_counter``'s registry for the products and attention
    ops it knows, the others 0), bytes accessed (each op's inputs and
    outputs, once an op), the peak of live storage the traced ops made, and
    each op's result bytes (for ``trace_top``).  Collectives are left to
    ``CollectiveCounter``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.by_op = defaultdict(int)       # op name -> result bytes summed
        self.rows = []                      # (result bytes, op name) per op
        self._seen = set()

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._seen:
            return
        n = s.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if collective_kind(func) is not None:
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **(kwargs or {}), out_val=out)
        name = func._overloadpacket.__name__
        outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        for t in outs:
            self._track(t)
        if name in _FREE or getattr(func, "is_view", False):
            return out
        ins = [x for x in tree_flatten((args, kwargs or {}))[0] if isinstance(x, torch.Tensor)]
        result = sum(_bytes(t) for t in outs)
        self.bytes_accessed += sum(_bytes(t) for t in ins) + result
        self.by_op[name] += result
        self.rows.append((result, name))
        return out


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   n_chips: int) -> Dict[str, float]:
    """Seconds a step for each roofline term (the counts are one rank's:
    callers pass ``n_chips`` 1), the dominant term and the bound."""
    compute_s = flops / (n_chips * PEAK_FLOPS)
    memory_s = bytes_accessed / (n_chips * HBM_BW)
    collective_s = coll_bytes / (n_chips * LINK_BW)
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    return dict(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        bound_s=max(compute_s, memory_s, collective_s),
    )
