"""Fault plans for the batch backend: the mask-expressible part of
``repro.faults`` (see ``plan``)."""
from .plan import FaultPlan, crash_window, slow_window  # noqa: F401
