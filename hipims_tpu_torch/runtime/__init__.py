"""Simulation runtime: the batch loop, outputs and progress reporting."""

from .simulation import Simulation, SimulationConfig  # noqa: F401
