"""Process-global chaos hook: the installed fault plan, if any.

A stdlib-only leaf module, so that any layer can consult the hook without
importing the serving subsystem; the plan itself is authored with
`distrifuser_tpu_torch.serve.faults.FaultPlan`, which re-exports these
three functions, so chaos tools keep one import surface.  Production code
never installs a plan; `active_fault_plan()` returning None is the steady
state.  (The JAX package's runner consults it at every fused-loop build,
site ``"runner.compile"``; the port's runner has no such site yet.)

The registry stores the plan opaquely (anything with a
``check(site, **kw)`` method); no fault semantics live here.
"""

from __future__ import annotations

from typing import Any, Optional

_ACTIVE_PLAN: Optional[Any] = None


def install_fault_plan(plan: Optional[Any]) -> None:
    """Install (or, with None, clear) the process-global fault plan."""
    global _ACTIVE_PLAN
    _ACTIVE_PLAN = plan


def active_fault_plan() -> Optional[Any]:
    return _ACTIVE_PLAN


def clear_fault_plan() -> None:
    install_fault_plan(None)
