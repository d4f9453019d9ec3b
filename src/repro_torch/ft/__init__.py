"""Fault tolerance of the port: the deterministic fault-injection harness
(``inject``) that the serve engine's degradation ladder is tested with."""
from repro_torch.ft.inject import Injector, SimulatedFailure, active, fire, flip_bit, seeded

__all__ = ["SimulatedFailure", "Injector", "active", "fire", "flip_bit", "seeded"]
