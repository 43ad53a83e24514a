"""Classifier-free-guidance branch handling.

Counterpart of distrifuser_tpu/parallel/guidance.py (``branch_select``,
``combine_guidance``).  Three layouts, branch 0 unconditional:

* ``cfg_split``: each rank runs one branch (``batch_idx``), and the guided
  output all-gathers the two branches over the ``split_group``;
* folded: both branches ride the batch dimension (2B);
* guidance off: one branch.
"""

from __future__ import annotations

from ..utils.config import DistriConfig
from .collectives import all_gather


def branch_select(cfg: DistriConfig, enc, added=None):
    """This rank's branch of branch-major inputs ``[n_br, B, ...]`` (CFG
    split), the branches folded into the batch dim (CFG on one rank group),
    or the single branch.  Returns (my_enc, my_added, batch_mult)."""
    if cfg.cfg_split:
        br = cfg.batch_idx()
        my_added = {k: v[br] for k, v in added.items()} if added is not None else None
        return enc[br], my_added, 1
    if cfg.do_classifier_free_guidance:
        my_enc = enc.reshape(-1, *enc.shape[2:])
        my_added = (
            {k: v.reshape(-1, *v.shape[2:]) for k, v in added.items()}
            if added is not None else None
        )
        return my_enc, my_added, enc.shape[0]
    my_added = {k: v[0] for k, v in added.items()} if added is not None else None
    return enc[0], my_added, 1


def combine_guidance(cfg: DistriConfig, out, gs, batch):
    """``u + gs * (c - u)`` in float32 (the JAX version promotes to float32
    through its float32 guidance scale), with the branches gathered over
    the split group (CFG split) or unfolded from the batch dim."""
    if cfg.cfg_split:
        both = all_gather(out, cfg.split_group)  # [2, B, ...]
        u, c = both[0].float(), both[1].float()
        return u + gs * (c - u)
    if cfg.do_classifier_free_guidance:
        u, c = out[:batch].float(), out[batch:].float()
        return u + gs * (c - u)
    return out
