"""Parameter trees from the JAX package into the PyTorch port.

``params_from_jax`` takes a UNet, CLIP or VAE tree as the JAX package
builds it, with numpy leaves (what ``jax.device_get`` returns), and gives
the port's tree: the same keys and nesting, tensors for leaves.  Layouts
that differ are transposed on the way:

* conv kernels (4-D ``kernel`` leaves) go from HWIO to OIHW, in
  channels_last memory format;
* linear kernels stay ``[in, out]``, as the port multiplies ``x @ kernel``;
* norms, biases and embeddings are copied as they are.

The leaves keep their dtype and land on the CPU; ``models.unet.cast_params``
casts and moves a converted tree.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a bf16 JAX tree
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def params_from_jax(tree):
    """The port's parameter tree for a JAX parameter tree with numpy leaves."""

    def convert(node, key):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, key) for v in node]
        t = _to_tensor(node)
        if key == "kernel" and t.dim() == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        if t.dim() == 4:
            return t.contiguous(memory_format=torch.channels_last)
        return t.contiguous()

    return convert(tree, None)
