"""Per-row quantization and dequantization: the hand-written Hopper kernels
of the quantized linears and of the refresh codec, and their wrappers.

Two kernels, each CUDA C++ for sm_90a, built with ``nvcc`` at first use
into ``build/kernels/`` and bound through a plain C entry point loaded with
``ctypes`` (ops/_build.py); their header comments give the design and what
bounds them:

* ``csrc/quantize_rows.cu`` encodes rows: per row the fp32 difference
  ``x - base`` (``x`` without a base), its max magnitude, the scale
  ``max(amax, 1e-12) / LIMIT`` and the int8 or e4m3 payload, in one read
  of the row.  No Pallas counterpart: the JAX package leaves
  ``distrifuser_tpu/parallel/compress.py`` ``quantize`` to XLA, which fuses
  it with the ops around it;
* ``csrc/dequantize_rows.cu`` decodes rows into a new buffer:
  ``cast(base + q * s)`` for a refreshed row, the previous buffer's row for
  every other row of a partial refresh.  The counterpart of the JAX
  package's ``dequantize``, also left to XLA.

Each launch takes a table of segments passed by value (one payload each;
``CAPACITY`` of them, a longer table is split into several launches; the
encoder has one instance per source type and residual base, so a table
that mixes them runs one launch of each).
The entry points:

* ``quantize_rows(x, mode)``: the rows of x [M, K] (bfloat16 or float32
  on the card, unit column stride); returns ``(q [M, K], s [M])``.  The A
  operand of ops/quant_matmul.py (ops/linear.py);
* ``quantize_rows_grouped(segments, mode)``: one launch over a list of
  ``EncodeSeg``: the rows of ``x`` minus ``base`` where given, only rows
  ``r, r + k, ...`` where ``every = (k, r)`` is given (a layout of
  several chunks, each a whole multiple of k rows, selects the same rows
  flattened).  ``x`` may be any [P?, d1?, d2?, d3, K] view with a unit
  column stride (a halo's two boundary slabs of a [B, h, W, C] activation
  read in place, the outermost dim of a 5-D x being the part whose
  payload and scale rows may lie at any offset, as the flat send buffer
  of a flush holds them: ``out = (q, s)``); returns each segment's ``(q
  [..., L / k, K], s [..., L / k])``.  Every compressed refresh of the
  patch path;
* ``dequantize_rows_grouped(segments, dtype)``: one launch over a list of
  ``DecodeSeg``; returns for each a new buffer [..., L, K] of ``dtype``
  whose rows are ``cast(base + q * s)`` (``q * s`` without a base), and
  with ``every = (k, r)`` only rows ``r, r + k, ...``, the others
  ``prev``'s.  ``q`` [P, ..., L / k, K] and ``s`` [P, ..., L / k] are
  tensors (a 2-D q is one part) or sequences of P parts (the two halves of
  a halo exchange, each in its own receive buffer), stacked on a new
  leading dim.

``every``'s ``r`` is an int or a one-element device tensor (``step % k``
under CUDA graphs, read by the kernel: one graph serves every rotation).

The plain versions are the compositions of parallel/compress.py that the
patch context ran before the codec fused them: ``x.float() -
base.float()``, ``take_every_kth``, ``quantize``; ``dequantize``,
``take_every_kth(base).float() + ...``, ``.to(dtype)``,
``scatter_every_kth``, ``torch.stack``.  On the card each kernel is bit
for bit its plain version.  On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches its kernel or raises.  Each wrapper
counts its launches in its ``launches`` attribute (a grouped call, one a
launch of its split table).
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..parallel.compress import (check_every_kth, dequantize, quantize,
                                 scatter_every_kth, take_every_kth)
from ._build import KernelLibrary, add_launches, counts_launches, current_stream

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAYLOADS = {"int8": (0, torch.int8), "fp8": (1, torch.float8_e4m3fn)}
_PAYLOAD_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_SRC_BF16, _HAS_BASE = 1, 2  # QuantSpec.flags
_OUT_BF16 = 1  # DequantSpec.flags
_LL, _INT, _PTR = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
CAPACITY = 192  # segments one launch's table holds (csrc/refresh_codec.cuh kCapacity)


class _QuantSpec(ctypes.Structure):
    """csrc/quantize_rows.cu's QuantSpec, field for field."""

    _fields_ = [("src", _PTR), ("base", _PTR), ("q", _PTR), ("s", _PTR), ("rot", _PTR),
                ("src_stride", _LL * 4), ("dims", _INT * 4), ("base_part", _LL),
                ("base_ld", _LL), ("q_part", _LL), ("s_part", _LL), ("K", _INT),
                ("every", _INT), ("rot_const", _INT), ("flags", _INT)]


class _DequantSpec(ctypes.Structure):
    """csrc/dequantize_rows.cu's DequantSpec, field for field."""

    _fields_ = [("q", _PTR), ("s", _PTR), ("out", _PTR), ("base", _PTR), ("prev", _PTR),
                ("rot", _PTR), ("q_part", _LL), ("s_part", _LL), ("base_part", _LL),
                ("base_ld", _LL), ("prev_part", _LL), ("prev_ld", _LL), ("parts", _INT),
                ("full_rows", _INT), ("K", _INT), ("every", _INT), ("rot_const", _INT),
                ("flags", _INT)]


def _binder(prefix: str, spec):
    def bind(lib) -> None:
        fn = getattr(lib, prefix + "_grouped")
        fn.restype = ctypes.c_int
        fn.argtypes = [_PTR, _INT, _INT, _PTR]
        for name in ("_capacity", "_spec_bytes"):
            getattr(lib, prefix + name).restype = ctypes.c_int
            getattr(lib, prefix + name).argtypes = []
        variant = getattr(lib, prefix + "_variant")
        variant.restype = ctypes.c_int
        variant.argtypes = [_INT, _INT] + [ctypes.POINTER(_INT)] * 3
        if (getattr(lib, prefix + "_spec_bytes")() != ctypes.sizeof(spec)
                or getattr(lib, prefix + "_capacity")() != CAPACITY):
            raise RuntimeError(f"{prefix}: the ctypes segment layout ({ctypes.sizeof(spec)} "
                               f"bytes, {CAPACITY} a table) does not match the kernel's")
    return bind


_ENCODE = KernelLibrary("quantize_rows.cu", _binder("quantize_rows", _QuantSpec))
_DECODE = KernelLibrary("dequantize_rows.cu", _binder("dequantize_rows", _DequantSpec))


def build() -> str:
    """Compile and load ``csrc/quantize_rows.cu`` (ops/_build.py); returns
    the compiler's ptxas report, or "" when an earlier build was reused."""
    return _ENCODE.build()


def build_decode() -> str:
    """The same for ``csrc/dequantize_rows.cu``."""
    return _DECODE.build()


def variant(kind: str, table: int, mode: str) -> dict:
    """The compiled instance of the encode ("quantize") or decode
    ("dequantize") kernel for a table of ``table`` segments (1, 16, or
    any larger count: the full table) and ``mode``: registers a thread,
    spilled bytes a thread, the table's parameter bytes."""
    lib, prefix = (_ENCODE.lib, "quantize_rows") if kind == "quantize" else (
        _DECODE.lib, "dequantize_rows")
    regs, local, params = _INT(), _INT(), _INT()
    cap = table if table in (1, 16) else CAPACITY
    rc = getattr(lib, prefix + "_variant")(cap, _PAYLOADS[mode][0], ctypes.byref(regs),
                                           ctypes.byref(local), ctypes.byref(params))
    if rc != 0:
        raise RuntimeError(f"{prefix}_variant: cudaError {rc}")
    return {"registers": regs.value, "spill_bytes": local.value, "param_bytes": params.value}


class EncodeSeg(NamedTuple):
    """One payload of ``quantize_rows_grouped``: the rows of ``x`` (minus
    ``base``, of x's shape), those of ``every`` = (k, r) only, into ``out``
    = (q, s) or new tensors."""

    x: torch.Tensor
    base: Optional[torch.Tensor] = None
    every: Optional[Tuple[int, Any]] = None
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class DecodeSeg(NamedTuple):
    """One payload of ``dequantize_rows_grouped``: payload ``q`` and scales
    ``s``, the residual ``base`` and, under ``every`` = (k, r), ``prev``,
    the buffer whose other rows are kept (module docstring)."""

    q: Any
    s: Any
    base: Optional[torch.Tensor] = None
    prev: Optional[torch.Tensor] = None
    every: Optional[Tuple[int, Any]] = None


def payload_shape(shape: Sequence[int], every=None) -> Tuple[int, ...]:
    """The payload shape of source rows of ``shape``: axis -2 thinned by the
    partial refresh's k (raises where k does not divide it)."""
    shape = tuple(shape)
    if every is None:
        return shape
    k = int(every[0])
    check_every_kth(shape[-2], k)
    return (*shape[:-2], shape[-2] // k, shape[-1])


# -- plain versions ---------------------------------------------------------


def quantize_rows_reference(seg: EncodeSeg, mode: str):
    """The plain version of one encode segment (on any device): returns
    ``(q, s)``, written into ``seg.out`` where given."""
    src = seg.x.float()
    if seg.base is not None:
        src = src - seg.base.float()
    if seg.every is not None:
        src = take_every_kth(src, seg.every[0], seg.every[1])
    q, s = quantize(src, mode)
    if seg.out is None:
        return q, s
    seg.out[0].copy_(q)
    seg.out[1].copy_(s)
    return seg.out


def _decode_one(q, s, dtype, base, prev, every):
    new = dequantize(q, s, torch.float32)
    if every is None:
        if base is not None:
            new = base.float() + new
        return new.to(dtype)
    k, r = every
    if base is not None:
        new = take_every_kth(base, k, r).float() + new
    return scatter_every_kth(prev, new.to(dtype), k, r)


def dequantize_rows_reference(seg: DecodeSeg, dtype):
    """The plain version of one decode segment (on any device): returns a
    new buffer."""
    if isinstance(seg.q, (list, tuple)):
        part = lambda t, i: None if t is None else t[i]  # noqa: E731
        return torch.stack([_decode_one(qi, si, dtype, part(seg.base, i), part(seg.prev, i),
                                        seg.every)
                            for i, (qi, si) in enumerate(zip(seg.q, seg.s))])
    return _decode_one(seg.q, seg.s, dtype, seg.base, seg.prev, seg.every)


# -- the kernels' segment tables --------------------------------------------


def _check_cuda(t: torch.Tensor, who: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{who}: a tensor on {t.device}; the kernel takes CUDA tensors")


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """Elements between consecutive rows of ``t`` (every dim but the last
    flattened), where that is one stride and the columns are contiguous;
    else None."""
    if t.dim() == 0 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return None
    ld = None
    span = None  # elements the rows inside the current dim cover
    for size, stride in zip(reversed(t.shape[:-1]), reversed(t.stride()[:-1])):
        if size == 1:
            continue
        if ld is None:
            ld, span = stride, stride * size
        elif stride != span:
            return None
        else:
            span *= size
    return t.shape[-1] if ld is None else ld


def _parts(t: torch.Tensor, parts: int, who: str, what: str):
    """(part stride, row stride) of ``t`` in elements, whose first dim is
    the part dim where ``parts`` > 1; raises where a part's rows are not
    one stride apart with contiguous columns."""
    inner = t[0] if parts > 1 else t
    ld = _row_stride(inner)
    if ld is None:
        raise ValueError(f"{who}: {what} needs rows one stride apart with a unit column "
                         f"stride, got shape {tuple(t.shape)}, strides {t.stride()}")
    return (t.stride(0) if parts > 1 else 0), ld


def _rotation(every, device):
    """(k, device pointer or None, host r, tensor to keep alive) of a
    partial refresh's ``every``."""
    if every is None:
        return 1, None, 0, None
    k, r = int(every[0]), every[1]
    if k < 1:
        raise ValueError(f"every: k must be >= 1, got {k}")
    if isinstance(r, torch.Tensor):
        if r.numel() != 1 or r.device != device or r.is_floating_point():
            raise ValueError(f"every: r must be one integer on {device}, got {r.dtype} "
                             f"{tuple(r.shape)} on {r.device}")
        r = r.reshape(()).to(torch.int64)
        return k, r.data_ptr(), 0, r
    r = int(r)
    if not 0 <= r < k:
        raise ValueError(f"every: r = {r} outside [0, {k})")
    return k, None, r, None


def _encode_spec(seg: EncodeSeg, dtype, keep: List) -> Tuple[_QuantSpec, Tuple]:
    x = seg.x
    who = "quantize_rows"
    _check_cuda(x, who)
    if x.dtype not in _IN_CODES:
        raise ValueError(f"{who} kernel takes bfloat16 or float32, got {x.dtype}")
    if not 2 <= x.dim() <= 5 or x.shape[-1] == 0 or x.numel() == 0 or x.stride(-1) != 1:
        raise ValueError(f"{who}: x needs rows and a unit column stride, shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    pshape = payload_shape(x.shape, seg.every)
    if seg.out is None:
        q = torch.empty(pshape, dtype=dtype, device=x.device)
        s = torch.empty(pshape[:-1], dtype=torch.float32, device=x.device)
    else:
        q, s = seg.out
    if (tuple(q.shape) != pshape or q.dtype != dtype or tuple(s.shape) != pshape[:-1]
            or s.dtype != torch.float32 or q.device != x.device or s.device != x.device):
        raise ValueError(f"{who}: out must be ({dtype} {pshape}, float32 {pshape[:-1]}) on "
                         f"{x.device}, got ({q.dtype} {tuple(q.shape)}, {s.dtype} "
                         f"{tuple(s.shape)})")
    parts = x.shape[0] if x.dim() == 5 else 1
    rows = x.shape[1:-1] if x.dim() == 5 else x.shape[:-1]
    strides = x.stride()[1:-1] if x.dim() == 5 else x.stride()[:-1]
    dims = (1,) * (3 - len(rows)) + tuple(rows)
    dstr = (0,) * (3 - len(rows)) + tuple(strides)
    q_part, q_ld = _parts(q, parts, who, "out q")
    s_part, s_ld = _parts(s.unsqueeze(-1), parts, who, "out s")
    if q_ld != pshape[-1] or s_ld != 1:
        raise ValueError(f"{who}: out needs contiguous rows within a part")
    spec = _QuantSpec()
    spec.src, spec.q, spec.s = x.data_ptr(), q.data_ptr(), s.data_ptr()
    spec.src_stride[:] = [x.stride(0) if x.dim() == 5 else 0, *dstr]
    spec.dims[:] = [parts, *dims]
    spec.q_part, spec.s_part = q_part, s_part * 4
    spec.K = x.shape[-1]
    spec.flags = _SRC_BF16 if x.dtype == torch.bfloat16 else 0
    if seg.base is not None:
        base = seg.base
        if base.shape != x.shape or base.dtype != x.dtype or base.device != x.device:
            raise ValueError(f"{who}: base must be {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}, got {base.dtype} {tuple(base.shape)}")
        spec.base = base.data_ptr()
        spec.base_part, spec.base_ld = _parts(base, parts, who, "base")
        spec.flags |= _HAS_BASE
    k, rot, r, rt = _rotation(seg.every, x.device)
    spec.every, spec.rot, spec.rot_const = k, rot, r
    keep.append(rt)
    return spec, (q, s)


def _decode_spec(seg: DecodeSeg, dtype, keep: List) -> Tuple[_DequantSpec, torch.Tensor, int]:
    who = "dequantize_rows"
    if dtype not in _IN_CODES:
        raise ValueError(f"{who} kernel writes bfloat16 or float32, got {dtype}")
    listed = isinstance(seg.q, (list, tuple))
    if listed:
        qs, ss = list(seg.q), list(seg.s)
        if not qs or len(qs) != len(ss):
            raise ValueError(f"{who}: q and s need as many parts")
        q0, s0, parts = qs[0], ss[0], len(qs)
    else:
        parts = seg.q.shape[0] if seg.q.dim() >= 3 else 1
        qs, ss = [seg.q], [seg.s]
        q0, s0 = (seg.q[0], seg.s[0]) if seg.q.dim() >= 3 else (seg.q, seg.s)
    for t in qs + ss:
        _check_cuda(t, who)
    if q0.dtype not in _PAYLOAD_CODES or any(t.dtype != q0.dtype for t in qs):
        raise ValueError(f"{who}: q must be int8 or float8_e4m3fn, got {q0.dtype}")
    if q0.dim() < 2 or tuple(s0.shape) != tuple(q0.shape[:-1]) or any(
            t.dtype != torch.float32 for t in ss):
        raise ValueError(f"{who}: s must be float32 of q's shape without its last dim, got "
                         f"{tuple(s0.shape)} for q {tuple(q0.shape)}")
    if listed:
        q_part = qs[1].data_ptr() - qs[0].data_ptr() if parts > 1 else 0
        s_part = ss[1].data_ptr() - ss[0].data_ptr() if parts > 1 else 0
        for i in range(parts):
            if (tuple(qs[i].shape) != tuple(q0.shape) or tuple(ss[i].shape) != tuple(s0.shape)
                    or qs[i].data_ptr() - qs[0].data_ptr() != i * q_part
                    or ss[i].data_ptr() - ss[0].data_ptr() != i * s_part
                    or qs[i].device != q0.device or ss[i].device != q0.device):
                raise ValueError(f"{who}: the parts of q and s must have one shape and lie "
                                 "one stride apart on one device")
    else:
        q_part, s_part = (seg.q.stride(0), 4 * seg.s.stride(0)) if parts > 1 else (0, 0)
    if _row_stride(q0) != q0.shape[-1] or _row_stride(s0.unsqueeze(-1)) != 1:
        raise ValueError(f"{who}: q and s need contiguous rows within a part, got strides "
                         f"{q0.stride()} and {s0.stride()}")
    device = q0.device
    part_full = tuple(q0.shape)
    if seg.every is not None:
        k = int(seg.every[0])
        part_full = (*q0.shape[:-2], q0.shape[-2] * k, q0.shape[-1])
        check_every_kth(part_full[-2], k)
    out_shape = (parts, *part_full) if listed or seg.q.dim() >= 3 else part_full
    out = torch.empty(out_shape, dtype=dtype, device=device)
    spec = _DequantSpec()
    spec.q, spec.s, spec.out = q0.data_ptr(), s0.data_ptr(), out.data_ptr()
    spec.q_part, spec.s_part = q_part, s_part
    spec.parts, spec.full_rows, spec.K = parts, math.prod(part_full[:-1]), part_full[-1]
    spec.flags = _OUT_BF16 if dtype == torch.bfloat16 else 0
    for name in ("base", "prev"):
        t = getattr(seg, name)
        if t is None:
            continue
        if tuple(t.shape) != out_shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"{who}: {name} must be {dtype} {out_shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        part_stride, ld = _parts(t, parts if out.dim() > len(part_full) else 1, who, name)
        setattr(spec, name, t.data_ptr())
        setattr(spec, name + "_part", part_stride)
        setattr(spec, name + "_ld", ld)
    if seg.every is not None and seg.prev is None:
        raise ValueError(f"{who}: a partial refresh (every) needs prev, the rows it keeps")
    k, rot, r, rt = _rotation(seg.every, device)
    spec.every, spec.rot, spec.rot_const = k, rot, r
    keep.append(rt)
    return spec, out, _PAYLOAD_CODES[q0.dtype]


def _launch(lib, prefix: str, spec_type, specs, payload: int, device) -> int:
    """Launch ``specs`` in tables of at most the kernel's capacity, one
    group of tables per kernel instance (the specs' flags: source or output
    type, base); returns the launches made."""
    fn = getattr(lib, prefix + "_grouped")
    stream = current_stream(device.index if device.index is not None
                            else torch.cuda.current_device())
    by_flags = {}
    for spec in specs:
        by_flags.setdefault(spec.flags, []).append(spec)
    launches = 0
    for group in by_flags.values():
        for start in range(0, len(group), CAPACITY):
            chunk = group[start:start + CAPACITY]
            table = (spec_type * len(chunk))(*chunk)
            rc = fn(ctypes.addressof(table), len(chunk), payload, stream)
            if rc != 0:
                raise RuntimeError(f"{prefix} kernel launch failed: cudaError {rc}")
            launches += 1
    return launches


def _encode(segs: Sequence[EncodeSeg], mode: str):
    """Run ``segs``: the plain version on the CPU, else the kernel; returns
    (results, launches)."""
    if all(seg.x.device.type == "cpu" for seg in segs):
        return [quantize_rows_reference(seg, mode) for seg in segs], 0
    if mode not in _PAYLOADS:
        raise ValueError(f"not a quantizing mode: {mode!r}")
    code, dtype = _PAYLOADS[mode]
    keep: List = []
    specs, outs = [], []
    for seg in segs:
        spec, out = _encode_spec(seg, dtype, keep)
        if seg.x.device != segs[0].x.device:
            raise ValueError("quantize_rows_grouped: every segment on one device")
        specs.append(spec)
        outs.append(out)
    return outs, _launch(_ENCODE.lib, "quantize_rows", _QuantSpec, specs, code,
                         segs[0].x.device)


def _decode(segs: Sequence[DecodeSeg], dtype):
    first = lambda t: t[0] if isinstance(t, (list, tuple)) else t  # noqa: E731
    if all(first(seg.q).device.type == "cpu" for seg in segs):
        return [dequantize_rows_reference(seg, dtype) for seg in segs], 0
    keep: List = []
    specs, outs, codes = [], [], set()
    for seg in segs:
        spec, out, code = _decode_spec(seg, dtype, keep)
        if out.device != first(segs[0].q).device:
            raise ValueError("dequantize_rows_grouped: every segment on one device")
        specs.append(spec)
        outs.append(out)
        codes.add(code)
    if len(codes) != 1:
        raise ValueError("dequantize_rows_grouped: one payload type per call")
    return outs, _launch(_DECODE.lib, "dequantize_rows", _DequantSpec, specs, codes.pop(),
                         outs[0].device)


# -- entry points -----------------------------------------------------------


@counts_launches
def quantize_rows(x, mode: str):
    """Per-row symmetric quantization of x [M, K] to ``mode`` ("int8" or
    "fp8"): the kernel on the card, the plain version on the CPU.  Returns
    ``(q, s)``.  Counts each kernel launch in ``quantize_rows.launches``."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes x [M, K], got shape {tuple(x.shape)}; "
                         "wider row layouts go through quantize_rows_grouped")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_rows: x on {x.device}; the kernel takes a CUDA tensor")
    (got,), launches = _encode([EncodeSeg(x)], mode)
    add_launches(quantize_rows, launches)
    return got


@counts_launches
def quantize_rows_grouped(segments: Sequence[EncodeSeg], mode: str):
    """``quantize_rows`` of every segment, in one launch per ``CAPACITY``
    segments on the card; returns each segment's ``(q, s)``.  Counts each
    launch in ``quantize_rows_grouped.launches``."""
    got, launches = _encode(list(segments), mode)
    add_launches(quantize_rows_grouped, launches)
    return got


@counts_launches
def dequantize_rows_grouped(segments: Sequence[DecodeSeg], dtype):
    """The ``dtype`` buffer decoded from each segment (module docstring):
    the kernel on the card, in one launch per ``CAPACITY`` segments, the
    plain version on the CPU; returns each segment's buffer.
    Counts each launch in ``dequantize_rows_grouped.launches``."""
    got, launches = _decode(list(segments), dtype)
    add_launches(dequantize_rows_grouped, launches)
    return got
