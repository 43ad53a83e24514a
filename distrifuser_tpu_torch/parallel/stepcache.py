"""Temporal step-cache cadence: which steps run the whole UNet and which
only its shallow levels.

Counterpart of distrifuser_tpu/parallel/stepcache.py.  With
``step_cache_interval = I`` and ``step_cache_depth = K`` (DistriConfig) the
steps after the synchronous warmup run super-steps of
``[shallow x (I-1), full x 1]``, then a tail of ``rest % I`` shallow steps:

* a full step runs every block and keeps the deep subtree's output (the
  feature entering the first shallow up block, models/unet.py
  ``unet_forward(cache_depth=K)``) in the per-layer buffers under
  ``STEPCACHE_KEY``, kind "stepcache", which never goes on the wire;
* a shallow step runs only the shallow levels and resumes from that
  feature; the layers it skips emit nothing, so their buffers ride along
  unchanged (``PatchContext.carry_unconsumed``).

The cadence is shallow-first: every warmup step is a full step, so the
first step after the warmup may already reuse the cache.  The JAX package
compiles the cadence into ``run_cadence``'s scan; the port's loop is on the
host, so the cadence becomes the runner's list of step evaluations
(parallel/runner.py ``DenoiseRunner._phases``), classified step by step
with ``is_shallow_at``.
"""

from __future__ import annotations

from typing import Dict, Tuple

# The deep feature's entry among the per-layer buffers.
STEPCACHE_KEY = "stepcache.deep"


def cadence_split(rest: int, interval: int) -> Tuple[int, int]:
    """(complete super-steps, trailing shallow steps) of ``rest`` steps
    after the warmup."""
    if interval < 2:
        raise ValueError(f"step-cache interval must be >= 2, got {interval}")
    return divmod(rest, interval)


def is_shallow_step(k: int, interval: int) -> bool:
    """Is step ``k`` after the warmup (0-based) shallow?  Positions
    0..interval-2 of each super-step are, the last is the full refresh."""
    return (k % interval) < interval - 1


def is_shallow_at(i: int, cadence_start: int, interval: int) -> bool:
    """Is absolute step ``i`` shallow, the cadence starting at
    ``cadence_start`` (the first step after the warmup)?  False in the
    warmup and with the cache off."""
    return (interval > 1 and i >= cadence_start
            and is_shallow_step(i - cadence_start, interval))


def phase_step_counts(num_steps: int, warmup_steps: int, interval: int) -> Dict[str, int]:
    """How ``num_steps`` steps split: ``{"sync": warmup steps, "stale":
    full steps after it, "shallow": shallow steps after it}``; with the
    cache off (interval <= 1) every step after the warmup is a full one."""
    if num_steps <= 0:
        return {"sync": 0, "stale": 0, "shallow": 0}
    n_sync = min(warmup_steps + 1, num_steps)
    rest = num_steps - n_sync
    shallow = (rest - rest // interval) if interval > 1 else 0
    return {"sync": n_sync, "stale": rest - shallow, "shallow": shallow}


def shallow_step_count(num_steps: int, warmup_steps: int, interval: int) -> int:
    """How many of ``num_steps`` steps run shallow (0 with the cache off)."""
    return phase_step_counts(num_steps, warmup_steps, interval)["shallow"]
