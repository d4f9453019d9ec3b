"""Graph substrate of the port: CSR containers, SCC condensation,
generators and host reachability (numpy, copied from ``repro.graph`` so the
port imports nothing of the JAX package)."""
from repro_torch.graph.csr import CSRGraph, from_edges, ELLGraph
from repro_torch.graph.scc import condense_to_dag, tarjan_scc
from repro_torch.graph.generators import (
    random_dag,
    layered_dag,
    tree_dag,
    scale_free_dag,
    paper_dataset_analogue,
    PAPER_DATASETS,
)

__all__ = [
    "CSRGraph",
    "ELLGraph",
    "from_edges",
    "condense_to_dag",
    "tarjan_scc",
    "random_dag",
    "layered_dag",
    "tree_dag",
    "scale_free_dag",
    "paper_dataset_analogue",
    "PAPER_DATASETS",
]
