"""End-to-end serving driver on the PyTorch/CUDA port (the paper is an
indexing/serving system, so
this is the paper-kind end-to-end example): build the Distribution-Labeling
index on a dataset analogue and serve 100k batched requests through the
QueryEngine with correctness checks and throughput reporting.

The default run keeps an index snapshot under ``./oracle_snapshot``: the
first invocation builds and saves it, every later invocation cold-starts
through ``persist.load_oracle`` (checksum-verified) instead of rebuilding —
delete the directory to force a fresh build.

  PYTHONPATH=src python examples/serve_oracle_torch.py             # on the card
  PYTHONPATH=src python examples/serve_oracle_torch.py --device cpu
  PYTHONPATH=src python examples/serve_oracle_torch.py --dataset cit-Patents --scale 0.01
  PYTHONPATH=src python examples/serve_oracle_torch.py --backend all   # sweep backends
  PYTHONPATH=src python examples/serve_oracle_torch.py --mode daemon --rate 300 \
      --duration 3            # open-loop serving daemon (admission control,
                              # deadline shedding, circuit breaker)
  PYTHONPATH=src python examples/serve_oracle_torch.py --state-dir state
                              # a durable dynamic oracle (recovers when present)

The counterpart of ``examples/serve_oracle.py``; ``--device`` (default
``cuda``) is ``repro_torch.launch.serve``'s.
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    args = sys.argv[1:]
    if not any(a.startswith("--dataset") for a in args):
        sys.argv += ["--dataset", "citeseer", "--scale", "0.02"]
    if not any(a.startswith("--n-queries") for a in args):
        sys.argv += ["--n-queries", "100000"]
    if not any(a.startswith(("--snapshot-dir", "--state-dir")) for a in args):
        # cold-start from the saved snapshot when it exists; build + save it
        # on the first run
        sys.argv += ["--snapshot-dir", "oracle_snapshot"]
    main()
