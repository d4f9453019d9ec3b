"""Fault tolerance of the port: the training loop's checkpoint/restart
posture (``loop``) and the deterministic fault-injection harness the serve
engine's degradation ladder is tested with (``inject``)."""
from repro_torch.ft.inject import Injector, SimulatedFailure, active, fire, flip_bit, seeded
from repro_torch.ft.loop import FaultTolerantLoop

__all__ = ["FaultTolerantLoop", "SimulatedFailure", "Injector", "active", "fire", "flip_bit",
           "seeded"]
