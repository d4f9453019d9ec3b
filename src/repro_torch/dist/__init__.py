"""Distribution layer: multi-device execution patterns that are not
oracle-specific (the oracle's own sharded serve lives in
``repro_torch.serve``), the port of ``repro.dist``."""
from repro_torch.dist.pipeline import pipeline_apply

__all__ = ["pipeline_apply"]
