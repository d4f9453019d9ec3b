"""One rank of a multi-process run of the port's multi-device modes.

``tests/test_torch_mesh.py`` starts ``world`` of these over gloo on the CPU,
each with its rank, a ``FileStore`` path to meet at, a mesh shape and a job
file (a pickle of graphs, queries and what to run); each rank writes a
pickle of what it saw to ``<out>/rank<r>.pkl``:

    python tests/mesh_ranks.py RANK WORLD STORE DATA,MODEL JOB OUT

``one_rank_mesh`` gives a test a (1, 1) mesh in its own process.

Every rank runs the same calls on the same inputs, as the engine and the
mesh build require.  It imports the port only.
"""
import contextlib
import datetime
import pickle
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.build.engine_device import distribution_labeling_device
from repro_torch.core.api import build_oracle
from repro_torch.ft import inject
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.scc import condense_to_dag
from repro_torch.launch.mesh import form_mesh
from repro_torch.serve.budget import label_bytes, truncate_store

BACKENDS = ("sharded", "sharded_hop")
# how long a rank waits for the others: far below the test's own limit, so
# a rank left in a collective by one that failed raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=60)
LABEL_FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")


@contextlib.contextmanager
def one_rank_mesh(backend: str = "gloo"):
    """A (1, 1) mesh over a one-rank process group of this process (an
    in-memory store), torn down on the way out: the in-process tests' and
    the card tests' mesh."""
    if backend == "nccl":
        torch.cuda.init()   # the mesh then keeps the current device as it is
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            timeout=TIMEOUT)
    try:
        yield form_mesh((1, 1), ("data", "model"), timeout=TIMEOUT)
    finally:
        dist.destroy_process_group()


def _serve(co, q, be, out: dict, key, deadline=None) -> None:
    """One batch; its verdicts and the engine's counters, or the error."""
    try:
        pred = co.serve(q, backend=be, deadline=deadline)
    except ValueError as e:
        out[key] = ("ValueError", str(e))
        return
    st = co.engine.stats()
    out[key] = (pred, st["last_batch"], st["degradation"])


def run(job: dict, mesh) -> dict:
    res = {"serve": {}, "inject": {}, "deadline": {}, "build": {}}
    rank = dist.get_rank()
    for name, indptr, indices, q in job["graphs"]:
        g = CSRGraph(indptr, indices)
        co = build_oracle(g, device="cpu", mesh=mesh)
        assert co.engine.backend == "sharded"   # auto with a mesh
        for frac in (None, 0.5):
            co.engine.set_budget(None if frac is None else truncate_store(
                co.oracle, budget_bytes=int(label_bytes(co.oracle) * frac)))
            for be in BACKENDS:
                co.engine.reset_stats()
                _serve(co, q, be, res["serve"], (name, frac, be))
        co.engine.set_budget(None)
        for be in BACKENDS:
            # the first dispatch fails on every rank: all take the host rung
            co.engine.reset_stats()
            with inject.active(inject.Injector({"serve.device_dispatch": 0})):
                _serve(co, q, be, res["inject"], (name, be))
            # rank 0 alone is past its deadline: every rank takes the host
            # rung together, and no rank is left waiting in a collective
            co.engine.reset_stats()
            now = time.monotonic()
            _serve(co, q, be, res["deadline"], (name, be),
                   deadline=now - 1.0 if rank == 0 else now + 3600.0)
        if job["build"]:
            dag, _ = condense_to_dag(g)
            stats = {}
            o = distribution_labeling_device(dag, device="cpu", mesh=mesh, stats_out=stats)
            res["build"][name] = ({f: getattr(o, f) for f in LABEL_FIELDS}, stats)
    return res


def main(argv) -> int:
    rank, world, store, shape, job_path, out = argv
    rank, world = int(rank), int(world)
    shape = tuple(int(s) for s in shape.split(","))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        mesh = form_mesh(shape, ("data", "model"), timeout=TIMEOUT)
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        res = run(job, mesh)
        res["coordinate"] = mesh.get_coordinate()
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
