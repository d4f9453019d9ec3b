"""Deterministic fault injection for the oracle lifecycle.

``ft/loop.py`` proved the posture for the training loop with a single
``fail_at`` hook; this module promotes it into a registry of named,
seed-addressable injection points that the chaos test suite (and the
``repro_torch.launch.chaos`` smoke driver) aims at production code paths:

  ========================  =====================================================
  site                      fired by
  ========================  =====================================================
  ``build.wave``            ``build/engine.py`` before each wave sweep
  ``build.chunk``           before each speculative chunk
  ``build.spec_replay``     ``_correct_chunk`` between watermark rollback and
                            the surviving-entry re-append
  ``dynamic.publish``       ``dynamic/versioned.py`` mid-publish, after the
                            staged compacting rebuild, before the commit point
  ``serve.device_dispatch``  ``serve/engine.py`` before a device batch
  ``serve.retruncate``      ``serve/budget.py`` before the budget governor
                            re-truncates the label store (a budget apply)
  ``persist.pre_rename``    ``persist/blocks.py`` after the tmp write, before
                            the atomic rename
  ========================  =====================================================

Usage::

    from repro_torch.ft import inject

    with inject.active(inject.Injector({"build.wave": 3})):
        build_distribution_labels(g, impl="wave", checkpoint_dir=d)
    # -> SimulatedFailure on the 4th (0-based index 3) wave boundary

Injectors are deterministic: a rule maps a site to the occurrence index that
fires (every ``fire`` call counts occurrences per site).  ``seeded`` derives
the occurrence indices from a seed so chaos sweeps can address "a random but
reproducible crash point" without hand-picking indices.  Production code
calls ``fire`` unconditionally; with no active injector it is a counter
bump and nothing more.

Faults come in two flavors:

  * **hard failures** (``rules``) raise ``SimulatedFailure`` at the chosen
    occurrence — the crash/outage case,
  * **latency stalls** (``latency``) sleep at the chosen occurrences instead
    of raising — the slow-device / slow-publish case the serving daemon's
    latency-SLO circuit breaker and deadline shedding exist for.  A stalled
    call still runs; only its wall time changes, so stalls compose with the
    failure rules (a site can stall at one occurrence and fail at another).

``flip_bit`` is the load-time corruption primitive: one deterministic bit
flip in a file on disk, for testing that checksummed loads fail loudly.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from repro_torch.obs import metrics, trace
from repro_torch.obs.state import ON

_M_FAULTS = metrics.counter(
    "faults_injected_total", "simulated faults that actually fired, by kind",
    labelnames=("kind",))
_FAULT_STALL = _M_FAULTS.labels(kind="stall")
_FAULT_FAIL = _M_FAULTS.labels(kind="fail")


class SimulatedFailure(RuntimeError):
    """Raised by a fault-injection hook to emulate a crash.

    (Historically defined in ``ft/loop.py``; it lives here now and is
    re-exported there for compatibility.)"""


Rule = Union[int, Iterable[int]]


def _as_set(at: Rule) -> frozenset:
    return frozenset([at]) if isinstance(at, (int, np.integer)) else frozenset(at)


class Injector:
    """Deterministic injection plan: site -> occurrence index(es) that fail.

    ``rules`` maps a site name to the 0-based occurrence index at which
    ``fire(site)`` raises ``SimulatedFailure`` (or an iterable of such
    indexes).  ``latency`` maps a site to ``(occurrences, seconds)``: those
    occurrences SLEEP for ``seconds`` instead of raising — deterministic
    slow-path injection for deadline/SLO testing.  Occurrence counts live on
    the injector, so one plan can be inspected after the run (``counts``)
    and a fresh plan replays identically.  One occurrence counter per site
    feeds both rule kinds, so a plan addresses "stall the 2nd dispatch,
    kill the 5th" without double counting."""

    def __init__(self, rules: Optional[Dict[str, Rule]] = None,
                 latency: Optional[Dict[str, Tuple[Rule, float]]] = None):
        self.rules: Dict[str, frozenset] = {
            site: _as_set(at) for site, at in (rules or {}).items()
        }
        self.latency: Dict[str, Tuple[frozenset, float]] = {
            site: (_as_set(at), float(seconds))
            for site, (at, seconds) in (latency or {}).items()
        }
        self.counts: Dict[str, int] = {}
        self.fired: List[str] = []
        self.stalled: List[str] = []

    def fire(self, site: str, **info) -> None:
        idx = self.counts.get(site, 0)
        self.counts[site] = idx + 1
        lat = self.latency.get(site)
        if lat is not None and idx in lat[0]:
            # stall BEFORE the failure check: a site can be both slow and
            # then fail at a later occurrence, mirroring a degrading device
            self.stalled.append(f"{site}[{idx}]")
            _FAULT_STALL.inc()
            if ON.enabled:
                # the stall itself is a span: the exported timeline shows the
                # injected latency exactly where the dispatch paid it
                with trace.span("fault.stall", cat="fault",
                                args={"site": site, "occurrence": idx,
                                      "seconds": lat[1]}):
                    time.sleep(lat[1])
            else:
                time.sleep(lat[1])
        if idx in self.rules.get(site, ()):
            detail = " ".join(f"{k}={v}" for k, v in sorted(info.items()))
            self.fired.append(site)
            _FAULT_FAIL.inc()
            if ON.enabled:
                trace.event("fault.fail", cat="fault", site=site,
                            occurrence=idx, **info)
            raise SimulatedFailure(
                f"injected failure at {site}[{idx}]" + (f" ({detail})" if detail else ""))


def seeded(seed: int, sites: Dict[str, int]) -> Injector:
    """Seed-addressable plan: for each ``site -> horizon`` pick one
    occurrence index in ``[0, horizon)`` deterministically from ``seed``.
    Sites are consumed in sorted order so the plan depends only on
    ``(seed, sites)``."""
    rng = np.random.default_rng(seed)
    return Injector({s: int(rng.integers(0, max(int(h), 1)))
                     for s, h in sorted(sites.items())})


# ------------------------------------------------------------ active stack

_ACTIVE: List[Injector] = []


@contextlib.contextmanager
def active(injector: Injector):
    """Install ``injector`` for the duration of the block (stackable)."""
    _ACTIVE.append(injector)
    try:
        yield injector
    finally:
        _ACTIVE.remove(injector)


def fire(site: str, **info) -> None:
    """Production-side hook: raise if any active injector targets this
    occurrence of ``site``.  No-op (beyond counting) otherwise."""
    for inj in _ACTIVE:
        inj.fire(site, **info)


# ------------------------------------------------------- corruption tool

def flip_bit(path: str, seed: int = 0, offset: Optional[int] = None) -> int:
    """Flip one bit of the file at ``path`` in place; returns the byte
    offset touched.  Deterministic in ``(file size, seed)`` unless an
    explicit ``offset`` is given.  This is the chaos suite's "disk
    corruption" primitive for proving checksummed loads fail loudly."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    if offset is None:
        rng = np.random.default_rng(seed)
        # skip the first 16 bytes: corrupting an npy magic/header tests the
        # parser, not the checksum — the payload is the interesting target
        lo = min(16, size - 1)
        offset = int(rng.integers(lo, size))
    bit = 1 << int(np.random.default_rng(seed + 1).integers(0, 8))
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ bit]))
    return offset
