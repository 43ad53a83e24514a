"""Parameter trees: from the JAX package into the port, and quantized.

``params_from_jax`` takes a UNet, CLIP or VAE tree as the JAX package
builds it, with numpy leaves (what ``jax.device_get`` returns), and gives
the port's tree: the same keys and nesting, tensors for leaves.  Layouts
that differ are transposed on the way:

* conv kernels (4-D ``kernel`` leaves) go from HWIO to OIHW, in
  channels_last memory format;
* linear kernels stay ``[in, out]``, as the port multiplies ``x @ kernel``;
* norms, biases and embeddings are copied as they are;
* a JAX ``QuantizedTensor`` leaf (a weight-quantized tree) becomes the
  port's (parallel/compress.py): a conv payload goes to OIHW and its scale
  from ``[kh, kw, O]`` to ``[O, kh, kw]``, a linear payload is held
  column-major, fp8 payloads are reinterpreted byte for byte.

The leaves keep their dtype and land on the CPU; ``models.unet.cast_params``
casts and moves a converted tree.

The rest is the counterpart of the quantized-tree functions of
distrifuser_tpu/models/weights.py (``quantize_params``,
``set_quant_compute``, ``dequantize_params``, ``params_nbytes``).  The
quantized ``.npz`` save and load is ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.compress import (
    LEAF_COMPUTE_POLICIES,
    QuantizedTensor,
    quantize_weight,
    validate_weight_mode,
)

# kernels that never quantize: the model's output head, whose rounding
# error lands unattenuated in the predicted noise (the UNet's conv_out;
# "final_out" is the DiT/MMDiT head of the JAX package)
_DENSE_LAYERS = frozenset({"conv_out", "final_out"})

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a bf16 JAX tree
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    if arr.dtype.name == "float8_e4m3fn":  # ml_dtypes fp8 payload
        return torch.from_numpy(np.array(arr).view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(arr))  # a writable copy


def _is_jax_quantized(node) -> bool:
    """A JAX ``QuantizedTensor`` (duck-typed: the port imports nothing of
    the JAX package)."""
    return all(hasattr(node, a) for a in ("payload", "scale", "compute", "channel_tile"))


def _quantized_from_jax(node) -> QuantizedTensor:
    payload, scale = _to_tensor(node.payload), _to_tensor(node.scale)
    if payload.dim() == 4:  # HWIO -> OIHW; scale [kh, kw, O] -> [O, kh, kw]
        payload = payload.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        scale = scale.permute(2, 0, 1).contiguous()
    else:  # [in, out] held column-major
        payload = payload.t().contiguous().t()
    return QuantizedTensor(payload, scale, _TORCH_DTYPES[np.dtype(node.dtype).name],
                           node.compute, node.channel_tile)


def params_from_jax(tree):
    """The port's parameter tree for a JAX parameter tree with numpy leaves."""

    def convert(node, key):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, key) for v in node]
        if _is_jax_quantized(node):
            return _quantized_from_jax(node)
        t = _to_tensor(node)
        if key == "kernel" and t.dim() == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        if t.dim() == 4:
            return t.contiguous(memory_format=torch.channels_last)
        return t.contiguous()

    return convert(tree, None)


def _map_leaves(fn, node):
    if isinstance(node, dict):
        return {k: _map_leaves(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_leaves(fn, v) for v in node]
    return fn(node)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def _leaf_policy(policy: str) -> str:
    """Config-level "off" is the leaf-level "dequant"."""
    leaf = "dequant" if policy == "off" else policy
    if leaf not in LEAF_COMPUTE_POLICIES:
        raise ValueError(f"quant_compute policy must be 'off', 'auto', 'dot', or "
                         f"'pallas', got {policy!r}")
    return leaf


def quantize_params(tree, mode: str, *, compute: str = "dequant",
                    channel_tile: int = 1):
    """Quantize every matmul and conv kernel of a port tree to ``mode``
    ("int8" / "fp8"): each ``"kernel"`` leaf of two or more dims, except
    the output heads of ``_DENSE_LAYERS``, becomes a ``QuantizedTensor``
    tagged with the execution policy ``compute`` ("off" maps to
    "dequant").  Norms, biases and embeddings stay as they are.

    "none" returns the tree untouched and refuses one that already holds
    quantized leaves (it promises the dense weights).  On a tree quantized
    at the same mode, payloads and scales are kept and only the policy
    re-tags; a mode switch is refused, since requantizing compounds the
    rounding error."""
    validate_weight_mode(mode)
    compute = _leaf_policy(compute)
    if mode == "none":
        if any(isinstance(leaf, QuantizedTensor) for leaf in _leaves(tree)):
            raise ValueError(
                "quantize_params('none') on an already-quantized tree: 'none' "
                "promises the dense weights, which this tree no longer holds; "
                "rebuild from the dense tree or densify explicitly with "
                "dequantize_params"
            )
        return tree

    def walk(node, name=""):
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if isinstance(v, QuantizedTensor) and k == "kernel":
                if v.mode != mode:
                    raise ValueError(
                        f"quantize_params({mode!r}) on a tree already quantized "
                        f"at {v.mode!r}: requantizing compounds the rounding "
                        "error; rebuild from the dense tree")
                out[k] = v.with_compute(compute)
            elif (k == "kernel" and isinstance(v, torch.Tensor) and v.dim() >= 2
                  and name not in _DENSE_LAYERS):
                out[k] = quantize_weight(v, mode, compute=compute,
                                         channel_tile=channel_tile)
            else:
                out[k] = walk(v, k)
        return out

    return walk(tree)


def set_quant_compute(tree, policy: str):
    """Re-tag every ``QuantizedTensor`` leaf's execution policy without
    touching payloads or scales ("off" maps to "dequant"); identity on
    dense trees."""
    leaf = _leaf_policy(policy)
    return _map_leaves(
        lambda n: n.with_compute(leaf) if isinstance(n, QuantizedTensor) else n, tree)


def dequantize_params(tree):
    """Every ``QuantizedTensor`` leaf densified: the dequantized values the
    quantized forward computes with, not the original weights."""
    return _map_leaves(
        lambda n: n.dense() if isinstance(n, QuantizedTensor) else n, tree)


def params_nbytes(tree) -> int:
    """Device bytes of a parameter tree; a ``QuantizedTensor`` counts its
    payload and its scales."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, QuantizedTensor):
            total += leaf.nbytes
        else:
            total += leaf.numel() * leaf.element_size()
    return total
