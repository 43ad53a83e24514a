"""The closed-loop SLO controller's tier table (ControllerConfig.tiers).

The JAX package's controller walks an ordered tier table over the
quality/cost lattice per SLO class (full quality, then the step cache,
wire compression, PCPP partial refresh, reduced steps, and admission
control past the last tier).  Only the table's type, its default and its
validation are here, so that `ControllerConfig` validates as it does in
the JAX package; the controller itself comes with a later step of
ROADMAP item 16, and `InferenceServer` refuses ``controller.enabled``
until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from ..utils.config import validate_step_cache_knobs

# The virtual rung past the last tier: reject at admission instead of
# dispatching work that cannot hold its SLO (serve/errors.py
# AdmissionRejectedError).  Not a TierSpec — nothing executes there.
ADMISSION = "admission_control"


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One rung of the quality/cost lattice.

    ``cost`` is the tier's predicted service-time multiplier relative to
    the full tier (1.0) — the controller's forward model, calibrated
    against measured completions via cost-normalized observations.  The
    knob fields are ``None`` = leave the key's value alone; set = override
    on `apply_tier`.  ``steps_scale`` multiplies the request's step count
    (floor 1).  Knob overrides other than ``steps_scale`` apply to
    displaced-patch keys only — a pipefusion bucket still benefits from
    the step scaling, but the patch-protocol knobs don't exist there."""

    name: str
    cost: float
    step_cache: Optional[Tuple[int, int]] = None
    comm_compress: Optional[str] = None
    refresh_fraction: Optional[float] = None
    steps_scale: float = 1.0

    def validate(self) -> None:
        if not self.name or self.name == ADMISSION:
            raise ValueError(f"invalid tier name {self.name!r}")
        if not (0.0 < self.cost <= 1.0):
            raise ValueError(
                f"tier {self.name!r}: cost must be in (0, 1], got {self.cost}"
            )
        if self.step_cache is not None:
            validate_step_cache_knobs(*self.step_cache)
        if self.comm_compress is not None:
            from ..parallel.compress import validate_mode

            validate_mode(self.comm_compress)
        if self.refresh_fraction is not None:
            from ..parallel.compress import validate_refresh_fraction

            validate_refresh_fraction(self.refresh_fraction)
        if not (0.0 < self.steps_scale <= 1.0):
            raise ValueError(
                f"tier {self.name!r}: steps_scale must be in (0, 1], got "
                f"{self.steps_scale}"
            )


# The default walk down the lattice: full → step
# cache → wire compression → PCPP partial refresh → reduced steps →
# admission control at the extreme.  Costs are the forward-model priors —
# the closed loop corrects for a mesh where they are off, since tier
# escalation keys off MEASURED windows too.
DEFAULT_TIERS: Tuple[TierSpec, ...] = (
    TierSpec("full", 1.0),
    TierSpec("step_cache", 0.75, step_cache=(2, 1)),
    TierSpec("comm_compress", 0.65, step_cache=(2, 1), comm_compress="int8"),
    TierSpec("partial_refresh", 0.55, step_cache=(2, 1),
             comm_compress="int8", refresh_fraction=0.5),
    TierSpec("reduced_steps", 0.3, step_cache=(2, 1), comm_compress="int8",
             refresh_fraction=0.5, steps_scale=0.5),
)


def normalize_tier_table(tiers: Sequence[Any]) -> Tuple[TierSpec, ...]:
    """Validate a tier table (ControllerConfig.tiers): TierSpec instances
    or mapping entries, unique names, the first tier the cost-1.0
    identity, costs strictly decreasing (the walk must actually get
    cheaper — equal-cost rungs would make the controller burn a cooldown
    for nothing).  () resolves to `DEFAULT_TIERS`."""
    if not tiers:
        return DEFAULT_TIERS
    specs: List[TierSpec] = []
    for entry in tiers:
        if isinstance(entry, TierSpec):
            spec = entry
        elif isinstance(entry, dict):
            kw = dict(entry)
            if kw.get("step_cache") is not None:
                kw["step_cache"] = tuple(int(x) for x in kw["step_cache"])
            spec = TierSpec(**kw)
        else:
            raise ValueError(
                f"tier table entries must be TierSpec or dict, got "
                f"{type(entry).__name__}"
            )
        spec.validate()
        specs.append(spec)
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"tier names must be unique, got {names}")
    if specs[0].cost != 1.0:
        raise ValueError(
            "the first tier is the full-quality identity and must have "
            f"cost 1.0, got {specs[0].cost} ({specs[0].name!r})"
        )
    for a, b in zip(specs, specs[1:]):
        if b.cost >= a.cost:
            raise ValueError(
                f"tier costs must strictly decrease along the table: "
                f"{a.name!r} ({a.cost}) -> {b.name!r} ({b.cost})"
            )
    return tuple(specs)
