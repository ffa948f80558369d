"""Fault injection and the consistency audit (port of ``repro.faults``).

- ``plan``  — the declarative :class:`FaultPlan`: timed, periodic and
  randomized ("storm") fault events, compiled to scheduler callbacks for
  the discrete-event engines (``apply_plan``) and to per-node availability
  masks for the batch backend (``FaultPlan.to_masks``).
- ``audit`` — per-key linearizability checking of client histories against
  the replicas' applied logs (``audit_cluster`` / ``check_history``).
"""
from .audit import (AuditResult, applied_ops, audit_cluster,  # noqa: F401
                    check_history, commit_apply_gap)
from .plan import (FaultPlan, add_node, apply_plan, crash_window,  # noqa: F401
                   drop_window, partition_window, periodic_crash,
                   remove_node, replace_leader, rolling_restart,
                   slow_window, storm)
