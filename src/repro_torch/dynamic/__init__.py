"""The port's dynamic oracle (the counterpart of ``repro.dynamic``).

Only ``workload.poisson_times``, the open-loop arrival process the serving
daemon's driver draws from, is ported so far; the dynamic oracle itself
(``delta``, ``repair``, ``versioned``, ``durable`` and the rest of
``workload``) comes with ROADMAP.md Queue 1 item 9.
"""
