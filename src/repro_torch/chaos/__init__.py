"""Chaos plane of the port: the seeded fault plan
(:mod:`repro_torch.chaos.faults`), whose crash / restart schedule the
fleet gateway applies once per pump.  The chaos transport and the
reliable sender of the JAX package's ``repro.chaos`` are not ported
yet."""

from .faults import FaultInjector, LinkPlan

__all__ = ["FaultInjector", "LinkPlan"]
