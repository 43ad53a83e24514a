"""Batch-row packing for the explicit stepwise carries (packed cohort step).

Counterpart of distrifuser_tpu/parallel/rowpack.py (``LeafAxes``,
``axes_from_shapes``, ``pack_rows``, ``extract_row``,
``AmbiguousPackAxisError``), over trees of tensors instead of JAX pytrees.

`PipelineExecutor.step_run` advances each resident request's explicit
denoise carry (runner.stepwise_carry_init/...step) padded to the prepared
batch width with copies of its single real row.  Batch rows are
independent end to end (every image a row of its own, the CFG branches
folded per row), so N cohort members whose next step runs the SAME
evaluation -- same (phase, state, shallow) signature -- can share ONE
dispatch: member r's real row rides batch row r, the per-row inputs (step
index, guidance scale, scheduler coefficients) become [B] vectors, and
every row's numerics are byte-identical to its solo run.  This module is
the carry-layout half of that contract:

* **axis discovery** (`axes_from_shapes`): given the carry's leaf shapes at
  two batch widths (w and 2w), the batch axis of each leaf is the unique
  axis whose dim doubled.  Leaves that don't scale are either per-run
  scalars (scheduler state: packed as a stacked [B] vector -- the
  schedulers accept per-row state, schedulers/scheduling.py `_per_row`)
  or batch-less shared leaves that pass through untouched.  An ambiguous
  leaf (two axes doubled) raises -- the executor falls back to sequential
  dispatch, never guesses.

* **fold-aware row indexing**: a batch-bearing axis holds ``f * width``
  entries with the request row MINOR -- CFG folding concatenates the batch
  block per branch (``cat([x, x])``) -- so row ``r`` of a width-``w`` carry
  occupies positions ``{r, w + r, 2w + r, ...}``.  Pack/extract reshape the
  axis to ``(f, width)`` and index the minor factor.

* **pack/extract** (`pack_rows` / `extract_row`): pack slices each member's
  real row into consecutive packed rows (padding by repeating the last
  member -- the `_pad_batch` convention); extract slices one row back out
  and tiles it across the width, reproducing the solo layout exactly (a
  solo carry's rows are identical by construction, so ``extract(pack)`` is
  byte-equal to never having packed).

Trees are tuples, lists and dicts (keys in sorted order, as JAX flattens
them) of tensors; None is an empty subtree, as in JAX.  `tree_flatten`
returns a hashable structure, so callers can cache a plan per structure.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch


class AmbiguousPackAxisError(ValueError):
    """A carry leaf's batch axis could not be identified uniquely --
    packing would be a guess, so the caller must fall back to sequential
    per-slot dispatch (correctness-first)."""


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves in order, hashable structure) of a tree of tuples, lists
    and dicts; None is an empty subtree, every other object a leaf."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (tuple, list)):
            return (type(t).__name__, tuple(walk(x) for x in t))
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(structure: Any, leaves: Sequence[Any]) -> Any:
    """The tree of ``structure`` (from `tree_flatten`) over ``leaves``."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        items = [build(c) for c in s[1]]
        return tuple(items) if kind == "tuple" else items

    out = build(structure)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over after unflatten")
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


class LeafAxes:
    """Per-leaf packing plan: ``axis`` is the batch-bearing axis (None for
    per-run scalars and batch-less shared leaves), ``ndim`` the leaf rank
    at the SOLO width (distinguishes a scalar scheduler leaf, which packs
    to a stacked [B] vector, from a shared leaf)."""

    __slots__ = ("axis", "ndim")

    def __init__(self, axis, ndim):
        self.axis = axis
        self.ndim = ndim

    def __eq__(self, other):
        return (isinstance(other, LeafAxes)
                and (self.axis, self.ndim) == (other.axis, other.ndim))

    def __repr__(self):  # debugging aid only
        return f"LeafAxes(axis={self.axis}, ndim={self.ndim})"


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _leaf_axes(small: Sequence[int], big: Sequence[int]) -> LeafAxes:
    small, big = tuple(small), tuple(big)
    if len(small) != len(big):
        raise AmbiguousPackAxisError(
            f"carry leaf rank changed with batch width: {small} vs {big}"
        )
    doubled = [a for a, (s, b) in enumerate(zip(small, big))
               if s > 0 and b == 2 * s]
    if not doubled:
        return LeafAxes(None, len(small))
    if len(doubled) > 1:
        raise AmbiguousPackAxisError(
            f"carry leaf {small} has multiple batch-scaled axes {doubled}"
        )
    return LeafAxes(doubled[0], len(small))


def axes_from_shapes(small_tree: Any, big_tree: Any) -> List[LeafAxes]:
    """Per-leaf packing plan from the carry's shapes at width w
    (``small_tree``) and width 2w (``big_tree``) -- trees of tensors
    (``meta`` tensors cost nothing) or shape tuples with identical
    structure.  Returns a flat list in `tree_leaves` order."""
    small_leaves, small_s = tree_flatten(small_tree)
    big_leaves, big_s = tree_flatten(big_tree)
    if len(small_leaves) != len(big_leaves) or small_s != big_s:
        raise AmbiguousPackAxisError(
            "carry structure changed with batch width: "
            f"{len(small_leaves)} vs {len(big_leaves)} leaves"
        )
    return [_leaf_axes(_shape(s), _shape(b))
            for s, b in zip(small_leaves, big_leaves)]


def _row_block(leaf: torch.Tensor, row: int, axis: int, width: int):
    """Slice row ``row`` (keepdims) out of a fold-major/batch-minor axis:
    view dim ``f * width`` as ``(f, width)``, index the minor factor."""
    d = leaf.shape[axis]
    if d % width:
        raise AmbiguousPackAxisError(
            f"batch axis dim {d} is not a multiple of width {width}"
        )
    f = d // width
    shaped = leaf.reshape(tuple(leaf.shape[:axis]) + (f, width)
                          + tuple(leaf.shape[axis + 1:]))
    return shaped.narrow(axis + 1, row, 1)


def pack_rows(carries: Sequence[Any], rows: Sequence[int],
              axes: List[LeafAxes], width: int) -> Any:
    """One packed carry whose row ``r`` is ``carries[r]``'s row
    ``rows[r]``, padded to ``width`` rows by repeating the last member.
    Members may be solo OR previously-packed carries -- the row index
    always addresses the member's own layout.  Every leaf of the result
    is a new tensor: no member's carry is aliased."""
    if not carries or len(carries) > width:
        raise ValueError(
            f"pack_rows wants 1..{width} members, got {len(carries)}"
        )
    flats = [tree_flatten(c) for c in carries]
    structure = flats[0][1]
    for leaves, st in flats[1:]:
        if st != structure:
            raise AmbiguousPackAxisError(
                "pack group members carry different tree structures"
            )
    if len(axes) != len(flats[0][0]):
        raise AmbiguousPackAxisError(
            f"pack plan covers {len(axes)} leaves; the carry has "
            f"{len(flats[0][0])}"
        )
    pad = width - len(carries)
    out = []
    for li, ax in enumerate(axes):
        leaves = [f[0][li] for f in flats]
        if ax.axis is None:
            if ax.ndim == 0:
                # per-run scheduler scalar -> stacked [width] vector (the
                # schedulers take per-row state); an already-packed member
                # contributes its own row
                vals = [l[r] if l.dim() > 0 else l
                        for l, r in zip(leaves, rows)]
                vals = vals + [vals[-1]] * pad
                out.append(torch.stack(vals))
            else:
                # batch-less shared leaf: identical across members by
                # construction; a copy, so no carry aliases another
                out.append(leaves[0].clone())
            continue
        blocks = [_row_block(l, r, ax.axis, width)
                  for l, r in zip(leaves, rows)]
        blocks = blocks + [blocks[-1]] * pad
        stacked = torch.cat(blocks, dim=ax.axis + 1)
        out.append(stacked.reshape(leaves[0].shape))
    return tree_unflatten(structure, out)


def extract_row(carry: Any, row: int, axes: List[LeafAxes],
                width: int) -> Any:
    """The solo-layout carry of packed row ``row``: every batch-bearing
    axis gets that row tiled across the full width (a solo carry's rows
    are identical by construction, so this reproduces the exact layout a
    never-packed run carries), scalar-stacked leaves index back down to
    their per-run scalar, shared leaves pass through as copies."""
    leaves, structure = tree_flatten(carry)
    out = []
    for leaf, ax in zip(leaves, axes):
        if ax.axis is None:
            if ax.ndim == 0 and leaf.dim() > 0:
                out.append(leaf[row].clone())
            else:
                out.append(leaf.clone())
            continue
        block = _row_block(leaf, row, ax.axis, width)
        reps = [1] * block.dim()
        reps[ax.axis + 1] = width
        out.append(block.repeat(*reps).reshape(leaf.shape))
    return tree_unflatten(structure, out)
