"""The benchmark of ``repro_torch``, the PyTorch and CUDA reachability oracle.

Run one cell as ``python3 bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout on a machine with
a CUDA card.  ``BENCHMARK.json`` at the root names the cells; everything a
cell needs is found by name under this directory:

  configs/<config>.json    a deployment's sizes and guarantees
  traffic/<traffic>.json   a traffic mix's parameters; its ``driver`` names
                           the generator and window in ``drivers/``
  metrics/<metric>.py      one reader a metric, ``read(run) -> float | None``

The yardstick lives here too: the input generators (``gen``), the plain
reference (``reference``) and the reduction of a profiler trace
(``profiling``).
Nothing here imports ``jax`` or the JAX package ``repro``.
"""
