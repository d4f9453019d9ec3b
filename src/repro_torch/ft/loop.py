"""The fault-tolerant training loop, the port of ``repro.ft.loop``.

Atomic step checkpoints (params, optimizer state and step) every
``ckpt_every`` steps and at the end, written off the critical path
(``AsyncCheckpointer``); on a (re)start the loop resumes from the latest
complete checkpoint.  The data pipeline is a pure function of (seed, step),
so no reader state is saved.  ``fail_at`` injects a ``SimulatedFailure``
once, before that step, which the tests and ``launch.train --fail-at`` use
to prove the restart.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.ft.inject import SimulatedFailure


class FaultTolerantLoop:
    def __init__(
        self,
        step_fn: Callable,           # (state, batch) -> (state, metrics)
        batch_fn: Callable,          # (step) -> batch
        init_state: Any,
        ckpt_dir: str,
        ckpt_every: int = 50,
        keep: int = 3,
        fail_at: Optional[int] = None,   # fault injection (tests)
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.state = init_state
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep=keep)
        self.fail_at = fail_at
        self.start_step = 0
        self.metrics_log: list[Dict] = []

    def maybe_restore(self) -> int:
        s = latest_step(self.ckpt_dir)
        if s is not None:
            self.state = restore_checkpoint(self.ckpt_dir, s, self.state)
            self.start_step = s
        return self.start_step

    def run(self, n_steps: int, log_every: int = 10) -> Any:
        step = self.maybe_restore()
        while step < n_steps:
            if self.fail_at is not None and step == self.fail_at:
                self.fail_at = None  # fail once
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            self.state, metrics = self.step_fn(self.state, batch)
            step += 1
            if step % self.ckpt_every == 0 or step == n_steps:
                self.ckpt.save(step, self.state)
            if step % log_every == 0 or step == n_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, sec=time.perf_counter() - t0)
                self.metrics_log.append(m)
        self.ckpt.wait()
        return self.state
