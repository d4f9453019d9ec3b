"""Device resolution shared by every entry point of the port.

The port runs on the card: ``build_oracle``, ``QueryEngine`` and the serve
driver take ``device="cuda"`` by default.  With no CUDA device they refuse
to carry on rather than quietly serving on the CPU; a caller that wants the
CPU (the tests do) asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Normalise ``device`` and check that it exists.

    ``"cuda"`` resolves to the current CUDA device index, so one card has one
    key wherever a tensor cache is keyed by device.  Raises ``RuntimeError``
    when a CUDA device is asked for and torch sees none.  ``"meta"`` (shapes
    and dtypes, no data) is for a dry run's trace (``launch.dryrun``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}: expected cuda, cpu or meta")
    return dev
