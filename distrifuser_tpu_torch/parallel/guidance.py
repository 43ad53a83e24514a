"""Classifier-free-guidance branch handling, single-device fold.

Counterpart of distrifuser_tpu/parallel/guidance.py.  At one device the two
CFG branches ride the batch dimension (2B); branch 0 is unconditional.  The
``cfg_split`` layout (one branch per rank group) is ROADMAP queue 1 item 7.
"""

from __future__ import annotations

from ..utils.config import DistriConfig


def branch_select(cfg: DistriConfig, enc, added=None):
    """Fold branch-major inputs ``[n_br, B, ...]`` into the batch dim (CFG)
    or take the single branch.  Returns (my_enc, my_added, batch_mult)."""
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
    """``u + gs * (c - u)`` from the folded batch, in float32 (the JAX
    version promotes to float32 through its float32 guidance scale)."""
    if cfg.do_classifier_free_guidance:
        u, c = out[:batch].float(), out[batch:].float()
        return u + gs * (c - u)
    return out
