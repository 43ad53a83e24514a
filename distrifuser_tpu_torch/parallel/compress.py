"""Quantization of weights and of the stale-refresh payloads, and the
PCPP partial-refresh row selection.

Counterpart of distrifuser_tpu/parallel/compress.py: ``quantize``,
``dequantize``, ``QuantizedTensor``, ``quantize_weight``, ``asdense`` and
the mode validation for the weights; ``COMPRESS_MODES``,
``COMPRESS_KINDS``, ``validate_mode``, ``refresh_period``,
``validate_refresh_fraction``, ``take_every_kth``, ``scatter_every_kth``
and ``wire_nbytes`` for the refresh exchanges of the displaced patch path
(parallel/context.py).  ``refresh_gather_seq`` serves only the DiT and
MMDiT sequence-parallel paths and comes with them (ROADMAP queue 1 items 13
and 14).  The arithmetic is the JAX package's,
so the same float32 input gives bit-identical payloads and scales: int8 is
``clip(round(x / s), -127, 127)`` with ``s = max(amax, 1e-12) / 127``
(``torch.round`` rounds half to even, as ``jnp.round`` does), fp8 is the
round-to-nearest cast of ``x / s`` with ``s = max(amax, 1e-12) / 448`` to
``torch.float8_e4m3fn`` (torch 2.1 or later, which the port requires).

Layouts follow the port's trees (models/weights.py), with the output
channels on one axis and the reduction on another:

* a linear kernel is ``[in, out]`` as in JAX; its payload is held
  column-major (the transpose of a contiguous ``[out, in]`` tensor, torch's
  Linear layout), which is the operand layout the CUDA kernel
  (ops/quant_matmul.py) reads.  The scale is ``[out]``, as in JAX;
* a conv kernel is OIHW; the reduction runs over dim 1 (input channels) and
  the scale is ``[O, kh, kw]`` (JAX's HWIO scale ``[kh, kw, O]`` permuted).

``channel_tile`` groups that many output channels per scale in both.

A refresh payload (a KV row, a halo row's channel vector) quantizes over
its last axis, one float32 scale per row: on the card through the kernel
of ops/quantize.py, whose plain version is ``quantize``.  "int8_residual"
quantizes the delta against the previous reconstruction with the int8
arithmetic.  The PCPP row groups index with a rotation ``r`` that may be a
device tensor (``index_select`` / ``index_copy``), so that one captured
CUDA graph serves every rotation.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

COMPRESS_MODES = ("none", "int8", "fp8", "int8_residual")
# the buffer kinds whose stale refresh compresses and thins; GroupNorm
# moments ("gn") are tiny and their var = E[x^2] - E[x]^2 cancellation
# amplifies payload error, "stepcache" and "local" never touch the wire
COMPRESS_KINDS = ("attn", "conv2d")
WEIGHT_QUANT_MODES = ("none", "int8", "fp8")
QUANT_COMPUTE_MODES = ("off", "auto", "dot", "pallas")
LEAF_COMPUTE_POLICIES = ("dequant", "auto", "dot", "pallas")

_INT8_MAX = 127.0
_FP8_MAX = 448.0
# an all-zero tile must dequantize to exact zeros, not NaNs from a 0/0
_SCALE_FLOOR = 1e-12


def _quantize_with_scale(xf, scale, mode: str):
    """Payload of float32 ``xf`` divided by a broadcastable ``scale``."""
    div = xf / scale
    if mode == "int8":
        return torch.clamp(torch.round(div), -_INT8_MAX, _INT8_MAX).to(torch.int8)
    return div.to(torch.float8_e4m3fn)


def quantize(x, mode: str, axis: int = -1):
    """Per-tile symmetric quantization over one reduction axis: returns
    ``(payload, scale)``, the payload int8 (or float8_e4m3fn for "fp8") of
    x's shape, the scale float32 of x's shape without ``axis``."""
    if mode not in ("int8", "fp8", "int8_residual"):
        raise ValueError(f"not a quantizing mode: {mode!r}")
    mode = payload_mode(mode)
    xf = x.float()
    amax = xf.abs().amax(dim=axis)
    limit = _INT8_MAX if mode == "int8" else _FP8_MAX
    scale = torch.clamp(amax, min=_SCALE_FLOOR) / limit
    return _quantize_with_scale(xf, scale.unsqueeze(axis), mode), scale


def dequantize(payload, scale, dtype, axis: int = -1):
    """Inverse of ``quantize`` (up to the per-tile rounding error)."""
    return (payload.float() * scale.unsqueeze(axis)).to(dtype)


def payload_mode(mode: str) -> str:
    """The payload arithmetic of a compression mode: "int8_residual" codes
    its delta as "int8" does."""
    return "int8" if mode == "int8_residual" else mode


def fp8_supported() -> bool:
    """Does this torch have the e4m3 payload dtype?"""
    return hasattr(torch, "float8_e4m3fn")


def validate_mode(mode: str) -> None:
    """Config-time validation of a refresh-compression mode."""
    if mode not in COMPRESS_MODES:
        raise ValueError(
            f"comm_compress must be one of {COMPRESS_MODES}, got {mode!r}"
        )
    if mode == "fp8" and not fp8_supported():
        raise ValueError("comm_compress='fp8' needs torch.float8_e4m3fn, which "
                         "this torch lacks; use 'int8' or 'int8_residual'")


def refresh_period(fraction: float) -> int:
    """``1 / fraction`` as the integer rotation period of the partial
    refresh (1: every row refreshes every stale step)."""
    return int(round(1.0 / float(fraction)))


def validate_refresh_fraction(fraction: float) -> None:
    """Config-time validation of a PCPP fraction: ``1/k`` for an integer
    ``k >= 1``, so that each stale step refreshes exactly one of k disjoint
    strided row groups."""
    f = float(fraction)
    if not 0.0 < f <= 1.0:
        raise ValueError(f"refresh_fraction must be in (0, 1], got {fraction!r}")
    k = round(1.0 / f)
    if k < 1 or abs(k * f - 1.0) > 1e-6:
        raise ValueError(
            "refresh_fraction must be 1/k for an integer k (1, 0.5, 0.25, "
            "...): each stale step refreshes one of k strided row groups "
            f"exactly — got {fraction!r}"
        )


def _rotation(r, device):
    """The rotation index as a one-element int64 tensor on ``device``."""
    if isinstance(r, torch.Tensor):
        return r.reshape(1).to(device=device, dtype=torch.long)
    return torch.tensor([int(r)], device=device)


def check_every_kth(rows: int, k: int, groups: int = 1) -> None:
    """Raise unless ``rows`` splits into ``groups`` chunks whose row counts
    the partial refresh's period ``k`` divides."""
    if rows % (groups * k):
        raise ValueError(
            f"partial refresh needs the row count ({rows}) divisible by "
            f"groups*k ({groups}*{k}) — pick a refresh_fraction whose "
            "period divides every refreshed row dimension"
        )


def take_every_kth(x, k: int, r, *, groups: int = 1):
    """Rows ``{r, r+k, r+2k, ...}`` along axis -2 of each of ``groups``
    equal contiguous segments: ``[..., L/k, C]``.  ``r`` is an int or a
    device tensor (one graph serves every rotation).  ``groups > 1`` is the
    layout whose axis -2 concatenates per-rank chunks: the stride applies
    within each chunk."""
    lead, rows, c = x.shape[:-2], x.shape[-2], x.shape[-1]
    check_every_kth(rows, k, groups)
    xg = x.reshape(*lead, groups, rows // (groups * k), k, c)
    sub = xg.index_select(xg.dim() - 2, _rotation(r, x.device))
    return sub.reshape(*lead, rows // k, c)


def scatter_every_kth(prev, rows, k: int, r, *, groups: int = 1):
    """Inverse of ``take_every_kth``: a new tensor, ``prev`` [..., L, C]
    with ``rows`` [..., L/k, C] written into the strided positions (same
    ``groups`` convention), in prev's dtype."""
    lead, n_rows, c = prev.shape[:-2], prev.shape[-2], prev.shape[-1]
    pg = prev.reshape(*lead, groups, n_rows // (groups * k), k, c).clone()
    up = rows.reshape(*lead, groups, n_rows // (groups * k), 1, c).to(prev.dtype)
    pg.index_copy_(pg.dim() - 2, _rotation(r, prev.device), up)
    return pg.reshape(prev.shape)


def wire_nbytes(shape: Sequence[int], itemsize: int, mode: str) -> int:
    """Bytes one exchange of a ``shape``-shaped tensor puts on the wire:
    the raw payload for "none", else one byte per element plus one float32
    scale per row (last-axis vector)."""
    n = int(math.prod(shape))
    if mode == "none":
        return n * itemsize
    tiles = int(math.prod(shape[:-1])) if len(shape) else 1
    return n + tiles * 4


def validate_weight_mode(mode: str) -> None:
    """Config-time validation of a weight-quantization mode."""
    if mode not in WEIGHT_QUANT_MODES:
        raise ValueError(
            f"weight_quant must be one of {WEIGHT_QUANT_MODES}, got {mode!r}"
        )


def validate_quant_compute(policy: str, weight_quant: str = "int8") -> None:
    """Config-time validation of a quantized-compute policy: forcing a
    low-precision path ("dot"/"pallas") without quantized kernels is a
    contradiction and is refused."""
    if policy not in QUANT_COMPUTE_MODES:
        raise ValueError(
            f"quant_compute must be one of {QUANT_COMPUTE_MODES}, got {policy!r}"
        )
    if policy in ("dot", "pallas") and weight_quant == "none":
        raise ValueError(
            f"quant_compute={policy!r} forces a low-precision matmul path but "
            "weight_quant='none' holds no quantized kernels; set weight_quant "
            "to int8/fp8 or keep quant_compute 'auto'/'off'"
        )


def validate_serve_quant_compute(policy: str, weight_quant: str) -> None:
    """The serve layer's check of a quantized-compute policy (ServeConfig,
    ExecKey): on a dense key ("none") only membership, since the policy
    has no quantized kernel to route there and is kept out of the key's
    identity; it names how the int8 key of the resilience ladder's
    ``weight_quant_on`` rung computes (``"pallas"``: the hand-written
    kernel).  The JAX package's ExecKey documents the same rule but its
    code refuses "dot"/"pallas" there, so its rung can only land on
    "auto"/"off" (ROADMAP queue 3).  A quantized key is checked in full."""
    validate_quant_compute(policy, weight_quant if weight_quant != "none" else "int8")


def _axes(ndim: int):
    """(reduction axis of the payload, output axis of the scale): OIHW conv
    kernels reduce over dim 1 and keep O first; linear kernels reduce over
    -2 and keep the output last."""
    return (1, 0) if ndim == 4 else (-2, -1)


class QuantizedTensor:
    """A quantized weight kernel: a 1-byte payload and one float32 scale
    per output-channel tile, densified where a consumer needs dense values.

    ``dtype`` is the compute dtype (what the dense leaf had); ``compute``
    the execution policy of a linear that consumes it ("dequant", "auto",
    "dot" or "pallas"; ops/gemm_routing.py); ``channel_tile`` the output
    channels per scale, with a partial last tile when they do not divide.
    """

    __slots__ = ("payload", "scale", "dtype", "compute", "channel_tile")

    def __init__(self, payload, scale, dtype, compute: str = "dequant",
                 channel_tile: int = 1):
        if compute not in LEAF_COMPUTE_POLICIES:
            raise ValueError(f"QuantizedTensor compute policy must be one of "
                             f"{LEAF_COMPUTE_POLICIES}, got {compute!r}")
        ct = int(channel_tile)
        if ct < 1:
            raise ValueError(f"channel_tile must be >= 1, got {channel_tile}")
        _, out_axis = _axes(payload.dim())
        n = payload.shape[out_axis]
        tiles = -(-n // ct)
        if scale.shape[out_axis] != tiles:
            raise ValueError(
                f"scale/payload tile misalignment: payload has {n} output "
                f"channels at channel_tile={ct} -> {tiles} scale tiles, but the "
                f"scale's output axis has {scale.shape[out_axis]}: a round-trip "
                "that dropped the tile size would dequantize with the wrong "
                "per-channel scales"
            )
        self.payload = payload
        self.scale = scale
        self.dtype = dtype
        self.compute = compute
        self.channel_tile = ct

    @property
    def shape(self):
        return self.payload.shape

    @property
    def ndim(self) -> int:
        return self.payload.dim()

    @property
    def mode(self) -> str:
        """The payload mode, "int8" or "fp8"."""
        return "int8" if self.payload.dtype == torch.int8 else "fp8"

    @property
    def nbytes(self) -> int:
        """Device residency: payload plus scales."""
        return int(self.payload.numel() * self.payload.element_size()
                   + self.scale.numel() * 4)

    def channel_scale(self):
        """The float32 scale expanded to one entry per output channel,
        whatever ``channel_tile`` is."""
        if self.channel_tile == 1:
            return self.scale
        _, out_axis = _axes(self.ndim)
        n = self.payload.shape[out_axis]
        expanded = torch.repeat_interleave(self.scale, self.channel_tile, dim=out_axis)
        return expanded.narrow(out_axis, 0, n)

    def dense(self):
        """The dequantized kernel in ``dtype`` (the counterpart of JAX's
        ``__jax_array__``), in the payload's memory layout."""
        reduce_axis, _ = _axes(self.ndim)
        return dequantize(self.payload, self.channel_scale(), self.dtype,
                          axis=reduce_axis)

    def to(self, device=None, dtype=None):
        """Payload and scale moved to ``device``, never cast; ``dtype``
        re-tags the compute dtype."""
        return QuantizedTensor(
            self.payload.to(device) if device is not None else self.payload,
            self.scale.to(device) if device is not None else self.scale,
            self.dtype if dtype is None else dtype, self.compute, self.channel_tile)

    def with_compute(self, compute: str):
        """The same payload and scale under another execution policy."""
        if compute == self.compute:
            return self
        return QuantizedTensor(self.payload, self.scale, self.dtype, compute,
                               self.channel_tile)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(shape={tuple(self.shape)}, payload="
                f"{self.payload.dtype}, dtype={self.dtype}, compute="
                f"{self.compute!r}, channel_tile={self.channel_tile})")


def _column_major(t):
    """A 2-D tensor with the same values, held column-major."""
    return t.t().contiguous().t()


def quantize_weight(w, mode: str, *, compute: str = "dequant",
                    channel_tile: int = 1) -> QuantizedTensor:
    """Quantize one kernel leaf (linear ``[in, out]`` or OIHW conv) with one
    float32 scale per output-channel tile; the tile's scale is the max of its
    channels' amax, and the last tile is partial when the channels do not
    divide."""
    if mode not in ("int8", "fp8"):
        raise ValueError(f"not a weight-quantizing mode: {mode!r}")
    if w.dim() not in (2, 4):
        raise ValueError(f"quantize_weight takes a linear [in, out] or an OIHW "
                         f"conv kernel, got shape {tuple(w.shape)}")
    reduce_axis, out_axis = _axes(w.dim())
    ct = int(channel_tile)
    xf = w.float()
    amax = xf.abs().amax(dim=reduce_axis)  # per output channel
    limit = _INT8_MAX if mode == "int8" else _FP8_MAX
    if ct <= 1:
        ct = 1
        scale = torch.clamp(amax, min=_SCALE_FLOOR) / limit
        per_ch = scale
    else:
        n = amax.shape[out_axis]
        tiles = -(-n // ct)
        moved = amax.movedim(out_axis, -1)
        # zero padding: a partial last tile's scale is the max of its real
        # channels only
        moved = torch.nn.functional.pad(moved, (0, tiles * ct - n))
        tile_amax = moved.reshape(*moved.shape[:-1], tiles, ct).amax(dim=-1)
        scale = (torch.clamp(tile_amax, min=_SCALE_FLOOR) / limit).movedim(-1, out_axis)
        per_ch = torch.repeat_interleave(scale, ct, dim=out_axis).narrow(out_axis, 0, n)
    q = _quantize_with_scale(xf, per_ch.unsqueeze(reduce_axis), mode)
    if w.dim() == 2:
        q = _column_major(q)
    else:
        q = q.contiguous(memory_format=torch.channels_last)
    return QuantizedTensor(q, scale.contiguous(), w.dtype, compute, ct)


def asdense(x):
    """Dequantize a ``QuantizedTensor``; identity on anything else."""
    return x.dense() if isinstance(x, QuantizedTensor) else x
