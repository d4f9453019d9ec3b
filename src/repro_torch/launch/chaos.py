"""Chaos smoke driver of the port: kill-and-resume build, corrupt-index
load, serve degradation, dynamic crash recovery, daemon kill-recover-drain
and a budget step-down — the fault-tolerance acceptance checks as one CLI.

  python -m repro_torch.launch.chaos                      # all, on the card
  python -m repro_torch.launch.chaos --device cpu         # all, on the CPU
  python -m repro_torch.launch.chaos --scenario build --seed 3

Each scenario prints PASS/FAIL and the driver exits nonzero if any fails,
so CI can run it directly.  All faults go through ``repro_torch.ft.inject``
and are deterministic in ``--seed``.  The counterpart of
``repro.launch.chaos``: the scenarios, their graphs and seeds are
``repro``'s; ``--device`` (default ``cuda``) is where the oracles serve.
"""
from __future__ import annotations

import argparse
import asyncio
import sys
import tempfile
import warnings

import numpy as np

from repro_torch.build.engine import build_distribution_labels
from repro_torch.core.api import build_oracle
from repro_torch.device import resolve_device
from repro_torch.dynamic import DurableDynamicOracle, DynamicOracle, UpdateBatch
from repro_torch.ft import inject
from repro_torch.ft.inject import SimulatedFailure
from repro_torch.graph.generators import layered_dag, random_dag
from repro_torch.obs import metrics, trace
from repro_torch.persist import CorruptSnapshotError, load_oracle, save_oracle


def _fields_equal(a, b) -> bool:
    return all(
        getattr(a, f).tobytes() == getattr(b, f).tobytes()
        for f in ("L_out", "L_in", "out_len", "in_len", "hop_rank")
    )


def scenario_build(seed: int, device="cuda") -> bool:
    """Kill the build at a seed-picked wave/chunk boundary, resume from the
    latest checkpoint, and require byte-identity with an uninterrupted run.
    (The host engines run on the host whatever ``device`` says.)"""
    ok = True
    for impl, g in (("wave", random_dag(300, 1200, seed=seed)),
                    ("speculative", layered_dag(240, 3.0, seed=seed + 1))):
        want = build_distribution_labels(g, impl=impl)
        with tempfile.TemporaryDirectory() as d:
            plan = inject.seeded(seed, {"build.wave": 8, "build.chunk": 6})
            try:
                with inject.active(plan):
                    build_distribution_labels(
                        g, impl=impl, checkpoint_dir=d, checkpoint_every=2)
                crashed = False
            except SimulatedFailure as e:
                crashed = True
                crash_at = str(e)
            got = build_distribution_labels(
                g, impl=impl, checkpoint_dir=d, checkpoint_every=2)
            ck = got.build_stats["checkpoint"]
            same = _fields_equal(want, got)
            ok &= same
            where = crash_at if crashed else "no boundary hit (ran clean)"
            print(f"  [{impl}] crash={where} resumed_from={ck['resumed_from']} "
                  f"byte-identical={same}")
    print(f"build kill-and-resume: {'PASS' if ok else 'FAIL'}")
    return ok


def scenario_corrupt(seed: int, device="cuda") -> bool:
    """Flip one bit in a saved index; the strict load must fail loudly and
    the non-strict load must quarantine exactly the corrupt block."""
    g = random_dag(150, 500, seed=seed)
    co = build_oracle(g, device=device)
    ok = True
    with tempfile.TemporaryDirectory() as d:
        save_oracle(d, co.oracle)
        clean = load_oracle(d)
        ok &= _fields_equal(co.oracle, clean)
        off = inject.flip_bit(f"{d}/L_out.00000.npy", seed=seed)
        try:
            load_oracle(d)
            print(f"  corrupt byte {off}: strict load DID NOT raise")
            ok = False
        except CorruptSnapshotError as e:
            print(f"  corrupt byte {off}: strict load failed loudly ({e})")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, report = load_oracle(d, strict=False)
        ok &= report.bad_blocks == ["L_out.00000"]
        print(f"  non-strict quarantined blocks: {report.bad_blocks} "
              f"({int(report.quarantine_out.sum())} rows)")
    print(f"corrupt-index load: {'PASS' if ok else 'FAIL'}")
    return ok


def scenario_serve(seed: int, device="cuda") -> bool:
    """Inject a device dispatch failure and a quarantined row set; verdicts
    must match the clean host path while the degradation counters move."""
    g = random_dag(200, 700, seed=seed)
    co = build_oracle(g, device=device)
    rng = np.random.default_rng(seed)
    q = rng.integers(0, g.n, size=(2000, 2)).astype(np.int32)
    want = co.engine.query_batch(q, backend="host")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with inject.active(inject.Injector({"serve.device_dispatch": 0})):
            got_dev = co.engine.query_batch(q, backend="dense")
    qmask = np.zeros(co.oracle.n, dtype=bool)
    qmask[rng.integers(0, co.oracle.n, size=co.oracle.n // 4)] = True
    co.engine.set_quarantine(qmask, None)
    got_search = co.engine.query_batch(q, backend="host")
    co.engine.set_quarantine(None, None)
    deg = co.engine.degradation
    ok = (bool((got_dev == want).all()) and bool((got_search == want).all())
          and deg["device_to_host"] > 0 and deg["searched"] > 0)
    print(f"  degradation counters: {deg}  verdicts-match="
          f"{bool((got_dev == want).all() and (got_search == want).all())}")
    print(f"serve degradation ladder: {'PASS' if ok else 'FAIL'}")
    return ok


def scenario_dynamic(seed: int, device="cuda") -> bool:
    """Crash a DurableDynamicOracle after WAL-acknowledged updates; recovery
    must agree with a fresh DynamicOracle fed the same batches."""
    g = random_dag(80, 260, seed=seed)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(3):
        ups = [(bool(rng.integers(0, 2)), int(rng.integers(0, g.n)),
                int(rng.integers(0, g.n))) for _ in range(6)]
        batches.append(UpdateBatch.of(
            inserts=[(u, v) for ins, u, v in ups if ins and u != v],
            deletes=[(u, v) for ins, u, v in ups if not ins and u != v]))
    with tempfile.TemporaryDirectory() as d:
        dur = DurableDynamicOracle(g, state_dir=d, device=device)
        dur.apply(batches[0])
        dur.publish()
        dur.apply(batches[1])
        dur.apply(batches[2])  # acknowledged, never published: the crash tail
        del dur  # crash
        rec = DurableDynamicOracle.recover(d, device=device)
        ref = DynamicOracle(g, device=device)
        for b in batches:
            ref.apply(b)
        ref.publish()
        q = rng.integers(0, g.n, size=(1500, 2)).astype(np.int32)
        same = bool((rec.serve(q) == ref.serve(q)).all())
        print(f"  recovered epoch={rec._epoch} replayed={rec.recovered_records} "
              f"rebuild-agreement={same}")
    print(f"dynamic crash-recovery: {'PASS' if same else 'FAIL'}")
    return same


def scenario_daemon(seed: int, device="cuda") -> bool:
    """Kill the serving daemon mid-serve over a durable oracle (with a WAL
    tail acknowledged but unpublished), restart, recover snapshot+WAL, and
    drain cleanly — recovered serving state must be byte-deterministic and
    agree with a never-crashed reference oracle."""
    import asyncio

    from repro_torch.serve.daemon import DaemonConfig, ServeDaemon, ShedError

    g = random_dag(250, 900, seed=seed)
    rng = np.random.default_rng(seed)

    def rand_batch(k: int = 40) -> UpdateBatch:
        ups = [(bool(rng.integers(0, 2)), int(rng.integers(0, g.n)),
                int(rng.integers(0, g.n))) for _ in range(k)]
        return UpdateBatch.of(
            inserts=[(u, v) for ins, u, v in ups if ins and u != v],
            deletes=[(u, v) for ins, u, v in ups if not ins and u != v])

    b_published, b_tail = rand_batch(), rand_batch()
    q_ref = rng.integers(0, g.n, size=(1200, 2)).astype(np.int32)
    report: dict = {}

    with tempfile.TemporaryDirectory() as d:
        dur = DurableDynamicOracle(g, state_dir=d, device=device)
        dur.apply(b_published)
        dur.publish()

        async def crash_phase() -> None:
            cfg = DaemonConfig(deadline_ms=1000.0, batch_window_ms=1.0,
                               backend="dense")
            daemon = ServeDaemon(dur, cfg)
            await daemon.start()
            ans_a = await daemon.submit(
                rng.integers(0, g.n, size=(64, 2)).astype(np.int32))
            dur.apply(b_tail)   # WAL-acknowledged, never published: crash tail
            killed = 0

            async def doomed() -> None:
                nonlocal killed
                try:
                    await daemon.submit(
                        rng.integers(0, g.n, size=(32, 2)).astype(np.int32))
                except ShedError as e:
                    killed += e.reason == "killed"

            # stall the next device dispatches so the kill lands mid-flight
            plan = inject.Injector(
                latency={"serve.device_dispatch": ([0, 1, 2], 0.3)})
            with inject.active(plan):
                tasks = [asyncio.create_task(doomed()) for _ in range(4)]
                await asyncio.sleep(0.08)
                await daemon.kill()
                await asyncio.gather(*tasks)
            report.update(answered=int(ans_a.shape[0]), killed=killed,
                          killed_state=daemon.state)

        asyncio.run(crash_phase())
        del dur   # crash: only the state dir survives

        rec = DurableDynamicOracle.recover(d, device=device)
        rec2 = DurableDynamicOracle.recover(d, device=device)
        report["recovery_deterministic"] = _fields_equal(
            rec._base_oracle, rec2._base_oracle)
        ref = DynamicOracle(g, device=device)
        ref.apply(b_published)
        ref.publish()
        ref.apply(b_tail)
        ref.publish()
        report["rebuild_agreement"] = bool(
            (rec.serve(q_ref) == ref.serve(q_ref)).all())

        async def drain_phase() -> None:
            daemon = ServeDaemon(rec, DaemonConfig(deadline_ms=1000.0))
            await daemon.start()
            parts = await asyncio.gather(
                *(daemon.submit(q_ref[i * 200:(i + 1) * 200])
                  for i in range(6)))
            stats = await daemon.drain()
            report["drained_clean"] = (daemon.state == "stopped"
                                       and stats["answered"] == stats["admitted"])
            report["recovered_serving_match"] = bool(
                (np.concatenate(parts) == ref.serve(q_ref)).all())

        asyncio.run(drain_phase())

    ok = (report["answered"] > 0 and report["killed"] > 0
          and report["killed_state"] == "killed"
          and report["recovery_deterministic"] and report["rebuild_agreement"]
          and report["drained_clean"] and report["recovered_serving_match"])
    print(f"  {report}")
    print(f"daemon kill-recover-drain: {'PASS' if ok else 'FAIL'}")
    return ok


class _FirstFire:
    """An injector that injects nothing: it sets ``event`` (on ``loop``, from
    whatever thread fires) when ``site`` first fires."""

    def __init__(self, site: str, loop):
        self.site, self.loop = site, loop
        self.event = asyncio.Event()
        self._fired = False

    def fire(self, site: str, **info) -> None:
        if site == self.site and not self._fired:
            self._fired = True
            self.loop.call_soon_threadsafe(self.event.set)


def scenario_budget(seed: int, device="cuda") -> bool:
    """Drive a memory-pressure step-down mid-serve: the budget governor must
    re-truncate the label store IN PLACE (no rebuild — the engine's full
    oracle object survives untouched) while stalled batches are in flight,
    drop no request, change no verdict, and step back up with hysteresis
    once the pressure signal clears."""
    import asyncio

    from repro_torch.serve.budget import BudgetController, PressureConfig, label_bytes
    from repro_torch.serve.daemon import DaemonConfig, ServeDaemon

    g = random_dag(400, 1400, seed=seed)
    co = build_oracle(g, device=device)
    rng = np.random.default_rng(seed)
    q_all = rng.integers(0, g.n, size=(2000, 2)).astype(np.int32)
    want = co.engine.query_batch(q_all, backend="host")
    co.engine.reset_stats()
    full_oracle = co.engine.oracle   # identity-checked below: never rebuilt
    full = label_bytes(co.oracle)

    sig = {"bytes": 0.0}   # scripted pressure signal (deterministic)
    ctl = BudgetController(
        co.engine,
        pressure=PressureConfig(watermark_bytes=full // 2, step_factor=0.5,
                                recovery_ticks=2, check_interval_s=0.02),
        pressure_source=lambda: sig["bytes"])
    report: dict = {}

    async def run() -> None:
        daemon = ServeDaemon(
            co, DaemonConfig(deadline_ms=2000.0, backend="dense",
                             batch_window_ms=1.0), budget_ctl=ctl)
        await daemon.start()
        answers: dict = {}

        async def ask(i: int) -> None:
            answers[i] = await daemon.submit(q_all[i * 80:(i + 1) * 80])

        # phase 1: clean serving at full labels
        await asyncio.gather(*(ask(i) for i in range(10)))
        # phase 2: pressure crosses the watermark while device dispatches
        # are stalled — the step-down must land in the gaps BETWEEN stalled
        # in-flight batches, never tear one.  The first arrival goes alone,
        # so the phase spans at least two stalled batches: a dispatch on the
        # card or the CPU is fast enough to take all ten in one batch, and
        # then there would be no gap for the step to land in.  The other
        # nine are submitted once its dispatch has reached the device (the
        # watcher sees the injection site fire), however long the loop, the
        # batcher or the executor take to get it there
        sig["bytes"] = float(full)
        plan = inject.Injector(
            latency={"serve.device_dispatch": (list(range(6)), 0.05)})
        began = _FirstFire("serve.device_dispatch", asyncio.get_running_loop())
        batches = daemon.counters["batches"]
        with inject.active(began), inject.active(plan):   # began sees the fire first
            first = asyncio.ensure_future(ask(10))
            await asyncio.wait_for(began.event.wait(), 60.0)
            await asyncio.gather(first, *(ask(i) for i in range(11, 20)))
        report["batches_mid_serve"] = daemon.counters["batches"] - batches
        report["steps_down_mid_serve"] = daemon.counters["budget_steps_down"]
        store = co.engine.budget_store
        report["truncated"] = store is not None and store.any_truncated
        # phase 3: budgeted serving continues under pressure
        await asyncio.gather(*(ask(i) for i in range(20, 25)))
        # phase 4: pressure clears; hysteresis must step all the way back up
        sig["bytes"] = 0.0
        for _ in range(300):
            await asyncio.sleep(0.02)
            if co.engine.budget_store is None:
                break
        report["stepped_back_up"] = co.engine.budget_store is None
        stats = await daemon.drain()
        report["answered"] = int(stats["answered"])
        report["admitted"] = int(stats["admitted"])
        report["shed"] = sum(v for k, v in stats.items() if k.startswith("shed_"))
        got = np.concatenate([answers[i] for i in range(25)])
        report["verdicts_match"] = bool((got == want).all())
        report["no_rebuild"] = co.engine.oracle is full_oracle
        report["retruncations"] = ctl.retruncations
        report["uncertain_searched"] = co.engine.degradation["uncertain"]

    asyncio.run(run())
    ok = (report["batches_mid_serve"] >= 2 and report["steps_down_mid_serve"] > 0
          and report["truncated"]
          and report["stepped_back_up"] and report["verdicts_match"]
          and report["no_rebuild"] and report["shed"] == 0
          and report["answered"] == report["admitted"])
    print(f"  {report}")
    print(f"budget pressure step-down: {'PASS' if ok else 'FAIL'}")
    return ok


SCENARIOS = {
    "build": scenario_build,
    "corrupt": scenario_corrupt,
    "serve": scenario_serve,
    "dynamic": scenario_dynamic,
    "daemon": scenario_daemon,
    "budget": scenario_budget,
}


def main(argv=None) -> dict:
    """Run the chosen scenarios; returns ``{name: passed}``, or exits 1 when
    any failed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="all",
                    choices=["all", *SCENARIOS])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the oracles serve (cuda|cpu)")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's Chrome-trace timeline here before "
                         "exiting (CI uploads it as a failure artifact)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry snapshot JSON here "
                         "before exiting")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = list(SCENARIOS) if args.scenario == "all" else [args.scenario]
    # every scenario runs even when an earlier one fails or raises — a crash
    # in one must not mask regressions in the rest, and the exit code must
    # report ALL failures, not just the first
    results: dict = {}
    for name in names:
        print(f"=== {name} ===")
        with trace.span(f"chaos.{name}", cat="chaos",
                        args={"seed": args.seed}):
            try:
                results[name] = bool(SCENARIOS[name](args.seed, device))
            except Exception as e:   # noqa: BLE001 - the driver is the backstop
                print(f"{name}: FAIL (unhandled {type(e).__name__}: {e})")
                results[name] = False
    failed = [n for n, ok in results.items() if not ok]
    if args.trace_out:
        trace.export_chrome(args.trace_out,
                            meta={"driver": "chaos", "seed": args.seed,
                                  "failed": failed})
        print(f"wrote trace -> {args.trace_out}")
    if args.metrics_out:
        metrics.export_json(args.metrics_out)
        print(f"wrote metrics -> {args.metrics_out}")
    if failed:
        print(f"chaos scenarios FAILED: {', '.join(failed)} "
              f"({len(failed)}/{len(results)})")
        sys.exit(1)
    print(f"all {len(results)} chaos scenarios passed")
    return results


if __name__ == "__main__":
    main()
