"""Process-global on/off switch for the observability layer.

Both ``repro_torch.obs.metrics`` and ``repro_torch.obs.trace`` read ``ON.enabled`` on
every hot-path operation.  The flag lives in its own module (no imports
from the rest of ``repro_torch.obs``) so instrumented code can do the cheapest
possible guard — one attribute load — before building span args or
touching a counter:

    from repro_torch.obs.state import ON
    ...
    if ON.enabled:
        SPAN_ARGS = {...}   # only allocated when obs is on

``obs.disable()`` therefore buys a true zero-allocation no-op path: guarded
call sites skip even the argument construction, and unguarded instrument
methods return before touching any state.
"""
from __future__ import annotations


class _ObsState:
    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = True


ON = _ObsState()


def enable() -> None:
    ON.enabled = True


def disable() -> None:
    ON.enabled = False


def enabled() -> bool:
    return ON.enabled
