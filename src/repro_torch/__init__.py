"""PyTorch/CUDA port of the reachability oracle.

The JAX package ``repro`` is the reference; this package mirrors its
sub-packages (``graph``, ``core``, ``build``, ``serve``, ``kernels``,
``obs``, ``ft``, ``launch``) and imports nothing of it.  The main path:

    from repro_torch.core.api import build_oracle
    co = build_oracle(g)          # device="cuda" by default
    co.serve(queries)             # backend "auto" -> the CUDA kernel

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
