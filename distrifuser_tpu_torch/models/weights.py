"""Parameter trees: from the JAX package into the port, and quantized.

``params_from_jax`` takes a UNet, CLIP or VAE tree (the VAE's encoder
and decoder) as the JAX package builds it, with numpy leaves (what ``jax.device_get`` returns), and gives
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

The DiT's and the MMDiT's ``blocks``, the MMDiT's ``blocks_dual`` and T5's
``layers``, stacked on a leading axis in the
JAX tree, become lists of per-layer trees (a stacked quantized leaf splits
into one ``QuantizedTensor`` a layer, the JAX package's per-layer scales).
The leaves keep their dtype and land on the CPU; ``models.unet.cast_params``
casts and moves a converted tree.

``convert_unet_state_dict``, ``convert_vae_state_dict``,
``convert_clip_state_dict``, ``convert_t5_state_dict``,
``convert_pixart_state_dict`` and ``convert_mmdit_state_dict`` are the counterparts of the JAX package's
converters of the same names: a diffusers or transformers state dict (the
tensors ``native.safetensors`` reads) straight to the port's tree, equal
to ``params_from_jax`` of the JAX converters' output.  Diffusers names are
normalised the same way (``to_out.0`` -> ``to_out``, ``ff.net.0.proj`` ->
``ff.net_0.proj``, ``ff.net.2`` -> ``ff.net_2``, norm ``weight`` ->
``scale``), conv kernels stay OIHW, in channels_last, linear kernels go
from ``[out, in]`` to ``[in, out]``, and the UNet's attention ``to_k`` and
``to_v`` fuse into one ``to_kv`` kernel.

The rest is the counterpart of the quantized-tree functions of
distrifuser_tpu/models/weights.py (``quantize_params``,
``set_quant_compute``, ``dequantize_params``, ``params_nbytes``) and of
its on-disk cache of converted trees, ``save_params`` / ``load_params``:
one flat ``.npz`` written with numpy, whose leaves follow the JAX
archive's rules (bf16 and fp8 leaves as raw bytes beside their dtype's
name, a ``QuantizedTensor`` as payload, float32 scale and the record of
compute dtype, payload dtype and ``channel_tile``) in the port's layout.
A reloaded tree feeds a pipeline as any tree does
(``DistriSDXLPipeline.from_params(cfg, unet_config, load_params(path),
...)``, with ``cfg.weight_quant`` the archive's mode and
``cfg.quant_compute`` the policy the leaves then take).
"""

from __future__ import annotations

from typing import Any, Dict

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


# the keys under which the JAX package stacks uniform layers on a leading
# axis (the DiT's and the MMDiT's blocks, the MMDiT's dual-attention
# prefix, T5's layers): the port holds them as lists
_STACKED = frozenset({"blocks", "blocks_dual", "layers"})


class _JaxQuantizedSlice:
    """One layer's slice of a stacked JAX ``QuantizedTensor`` leaf."""

    def __init__(self, node, i):
        self.payload, self.scale = node.payload[i], node.scale[i]
        self.compute, self.channel_tile, self.dtype = node.compute, node.channel_tile, node.dtype


def _unstack(node):
    """A dict of leaves stacked on a leading [depth] axis as a list of
    ``depth`` dicts."""
    if isinstance(node, dict):
        per_key = {k: _unstack(v) for k, v in node.items()}
        depth = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(depth)]
    if _is_jax_quantized(node):
        return [_JaxQuantizedSlice(node, i) for i in range(np.shape(node.payload)[0])]
    return list(np.asarray(node))


def params_from_jax(tree):
    """The port's parameter tree for a JAX parameter tree with numpy leaves;
    layers stacked on a leading axis (``blocks``, ``layers`` as dicts)
    become lists."""

    def convert(node, key):
        if isinstance(node, dict):
            return {k: ([convert(layer, None) for layer in _unstack(v)]
                        if k in _STACKED and isinstance(v, dict) else convert(v, k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, key) for v in node]
        if _is_jax_quantized(node):
            return _quantized_from_jax(node)
        t = _to_tensor(node)
        if key == "kernel" and t.dim() == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        return _layout(t)

    return convert(tree, None)


def _layout(t: torch.Tensor) -> torch.Tensor:
    """A leaf in the port's memory layout: 4-D in channels_last, else
    contiguous."""
    if t.dim() == 4:
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def _rename(parts):
    """Diffusers' ``net.0`` / ``net.2`` and ``to_out.0`` as the tree's
    ``net_0`` / ``net_2`` and ``to_out``."""
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if p == "net" and i + 1 < len(parts) and parts[i + 1] in ("0", "2"):
            out.append(f"net_{parts[i + 1]}")
            i += 2
        elif p == "to_out" and i + 1 < len(parts) and parts[i + 1] == "0":
            out.append("to_out")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def _convert_leaf(parts, value: torch.Tensor):
    """(tree path, tensor) of one state-dict entry: an embedding ``weight``
    becomes its parent key ("__direct__"), a 4-D ``weight`` a conv kernel
    (OIHW, as stored), a 2-D one a linear kernel ``[in, out]``, any other a
    norm ``scale``."""
    leaf = parts[-1]
    if leaf == "weight":
        if "embedding" in parts[-2]:
            return parts[:-1] + ["__direct__"], value
        if value.dim() == 4:
            return parts[:-1] + ["kernel"], value
        if value.dim() == 2:
            return parts[:-1] + ["kernel"], value.t()
        return parts[:-1] + ["scale"], value
    return parts, value


def _listify(tree):
    """Dicts whose keys are all digits as lists."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _listify(v) for k, v in tree.items()}
    if tree and all(k.isdigit() for k in tree):
        return [tree[str(i)] for i in range(len(tree))]
    return tree


def _fuse_kv(tree):
    """``to_k`` and ``to_v`` fused into ``to_kv`` ([k | v] columns)
    wherever a node holds both beside ``to_q`` (UNet attention)."""
    if isinstance(tree, list):
        return [_fuse_kv(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    tree = {k: _fuse_kv(v) for k, v in tree.items()}
    if "to_k" in tree and "to_v" in tree and "to_q" in tree and "group_norm" not in tree:
        k, v = tree.pop("to_k"), tree.pop("to_v")
        fused = {"kernel": torch.cat([k["kernel"], v["kernel"]], dim=1)}
        if "bias" in k:
            fused["bias"] = torch.cat([k["bias"], v["bias"]])
        tree["to_kv"] = fused
    return tree


def _convert(sd, dtype, *, skip=(), fuse_kv=False):
    tree: dict = {}
    for key, val in sd.items():
        if any(s in key for s in skip):
            continue
        parts, v = _convert_leaf(_rename(key.split(".")), val)
        if parts[-1] == "__direct__":
            parts = parts[:-1]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    tree = _listify(tree)
    if fuse_kv:
        tree = _fuse_kv(tree)
    return _map_leaves(lambda t: _layout(t.to(dtype)), tree)


def convert_unet_state_dict(sd, dtype=torch.float32):
    """A diffusers UNet2DConditionModel state dict as the port's UNet tree."""
    return _convert(sd, dtype, skip=("position_ids",), fuse_kv=True)


def convert_vae_state_dict(sd, dtype=torch.float32):
    """A diffusers AutoencoderKL state dict as the port's VAE tree (encoder,
    decoder, and quant_conv and post_quant_conv where the snapshot has them:
    SD3's has neither); the mid attentions' older
    names (query, key, value, proj_attn) are renamed, and their to_k / to_v
    stay apart."""
    renames = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out"}
    sd = {".".join(renames.get(p, p) for p in k.split(".")): v for k, v in sd.items()}
    return _convert(sd, dtype)


def convert_clip_state_dict(sd, dtype=torch.float32):
    """A transformers CLIPTextModel(WithProjection) state dict as the
    port's CLIP tree."""
    out = {}
    for k, v in sd.items():
        if k.endswith("position_ids"):
            continue
        k = k.replace("text_model.", "")
        k = k.replace("embeddings.token_embedding", "token_embedding")
        k = k.replace("embeddings.position_embedding", "position_embedding")
        k = k.replace("encoder.layers", "layers")
        out[k] = v
    return _convert(out, dtype)


def _lin(sd, key, dtype):
    """A linear layer of a state dict: kernel ``[in, out]``, bias if any."""
    out = {"kernel": sd[f"{key}.weight"].t()}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return _map_leaves(lambda t: _layout(t.to(dtype)), out)


def _fused(sd, key_k, key_v, dtype):
    """``to_k`` and ``to_v`` as one ``[in, 2 out]`` kernel ([k | v])."""
    k, v = _lin(sd, key_k, dtype), _lin(sd, key_v, dtype)
    out = {"kernel": torch.cat([k["kernel"], v["kernel"]], dim=1)}
    if "bias" in k:
        out["bias"] = torch.cat([k["bias"], v["bias"]])
    return out


def convert_t5_state_dict(sd, dtype=torch.float32):
    """A transformers T5EncoderModel state dict as the port's T5 tree:
    kernels ``[in, out]``, block 0's relative-attention table as the one
    shared ``relative_attention_bias``, the layers as a list."""
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.block."))
    gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in sd
    leaf = lambda k: _layout(sd[k].to(dtype))  # noqa: E731
    layers = []
    for i in range(n_layers):
        a, f = f"encoder.block.{i}.layer.0", f"encoder.block.{i}.layer.1"
        names = ("wi_0", "wi_1", "wo") if gated else ("wi", "wo")
        layers.append({
            "attn": {n: _lin(sd, f"{a}.SelfAttention.{n}", dtype) for n in "qkvo"},
            "attn_norm": leaf(f"{a}.layer_norm.weight"),
            "ff": {n: _lin(sd, f"{f}.DenseReluDense.{n}", dtype) for n in names},
            "ff_norm": leaf(f"{f}.layer_norm.weight"),
        })
    return {
        "shared": leaf("shared.weight"),
        "relative_attention_bias": leaf(
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "layers": layers,
        "final_norm": leaf("encoder.final_layer_norm.weight"),
    }


def convert_pixart_state_dict(sd, *, patch_size: int = 2, eps_channels: int = 4,
                              dtype=torch.float32):
    """A diffusers PixArtTransformer2DModel state dict as the port's DiT
    tree: the ps x ps patch-embed conv ``pos_embed.proj`` becomes the
    ``proj_in`` linear over patchify's (p, q, c) token order; each block's
    ``to_k`` / ``to_v`` fuse into ``attn_kv`` / ``cross_kv``; ``proj_out``'s
    learned-sigma rows are dropped (the epsilon channels of its (p, q, c)
    layout kept); the 1024-class resolution and aspect embedders come along
    where the checkpoint has them."""
    lin = lambda key: _lin(sd, key, dtype)  # noqa: E731
    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("transformer_blocks."))
    blocks = []
    for i in range(n_blocks):
        b = f"transformer_blocks.{i}"
        blocks.append({
            "scale_shift_table": _layout(sd[f"{b}.scale_shift_table"].to(dtype)),
            "attn_q": lin(f"{b}.attn1.to_q"),
            "attn_kv": _fused(sd, f"{b}.attn1.to_k", f"{b}.attn1.to_v", dtype),
            "attn_out": lin(f"{b}.attn1.to_out.0"),
            "cross_q": lin(f"{b}.attn2.to_q"),
            "cross_kv": _fused(sd, f"{b}.attn2.to_k", f"{b}.attn2.to_v", dtype),
            "cross_out": lin(f"{b}.attn2.to_out.0"),
            "mlp_fc1": lin(f"{b}.ff.net.0.proj"),
            "mlp_fc2": lin(f"{b}.ff.net.2"),
        })
    ps = patch_size
    pw = sd["pos_embed.proj.weight"]  # conv [hidden, C, ps, ps]
    hidden = pw.shape[0]
    ow, ob = sd["proj_out.weight"], sd["proj_out.bias"]  # [ps*ps*2C, hidden]
    out2 = ow.shape[0] // (ps * ps)
    ow = ow.reshape(ps, ps, out2, hidden)[:, :, :eps_channels]
    ob = ob.reshape(ps, ps, out2)[:, :, :eps_channels]
    tree = {
        "proj_in": {"kernel": pw.permute(2, 3, 1, 0).reshape(-1, hidden),
                    "bias": sd["pos_embed.proj.bias"]},
        "t_fc1": lin("adaln_single.emb.timestep_embedder.linear_1"),
        "t_fc2": lin("adaln_single.emb.timestep_embedder.linear_2"),
        "adaln": lin("adaln_single.linear"),
        "cap_fc1": lin("caption_projection.linear_1"),
        "cap_fc2": lin("caption_projection.linear_2"),
        "final_table": sd["scale_shift_table"],
        "final_out": {"kernel": ow.reshape(ps * ps * eps_channels, hidden).t(),
                      "bias": ob.reshape(-1)},
        "blocks": blocks,
    }
    for name in ("resolution_embedder", "aspect_ratio_embedder"):
        k1 = f"adaln_single.emb.{name}.linear_1"
        if f"{k1}.weight" in sd:
            tree[name] = {"fc1": lin(k1), "fc2": lin(f"adaln_single.emb.{name}.linear_2")}
    return _map_leaves(lambda t: _layout(t.to(dtype)), tree)


def convert_mmdit_state_dict(sd, dtype=torch.float32):
    """A diffusers SD3Transformer2DModel state dict as the port's MMDiT tree
    (models/mmdit.py), mapped as the JAX converter maps it:

    * ``pos_embed.proj`` (the ps x ps patch-embed conv) becomes the
      ``proj_in`` linear over patchify's (p, q, c) token order; the fixed
      ``pos_embed.pos_embed`` table is computed instead
      (``pos_embed_cropped``);
    * a block's q, k and v (``attn.to_{q,k,v}``, ``attn.add_{q,k,v}_proj``)
      fuse into ``x_qkv`` / ``c_qkv`` [h, 3h];
    * AdaLayerNormZero's 6 chunks are already (shift, scale, gate) x
      (attention, MLP); AdaLayerNormContinuous's 2 (the last block's
      ``norm1_context`` and ``norm_out``) are (scale, shift) and are swapped;
    * the last block's context stream (``context_pre_only``: no context
      queries, attention output or MLP) is zero-filled: the q third of
      ``c_qkv``, ``c_out``, ``c_fc*`` and the gate and MLP chunks of
      ``c_mod``, so the discarded context passes through unchanged; its
      absent ``norm_added_q`` is ones;
    * SD3.5-medium's dual attention (``attn2`` on a contiguous prefix of
      blocks): AdaLayerNormZeroX's 9 chunks split into ``x_mod`` (the first
      6) and ``blocks_dual``'s ``x_mod2`` (the last 3), ``attn2.to_{q,k,v}``
      fuse into ``x2_qkv``."""
    get = lambda k: sd[k]  # noqa: E731
    lin = lambda key: _lin(sd, key, dtype)  # noqa: E731

    def fused3(kq, kk, kv):
        parts = [_lin(sd, k, dtype) for k in (kq, kk, kv)]
        out = {"kernel": torch.cat([p["kernel"] for p in parts], dim=1)}
        if "bias" in parts[0]:
            out["bias"] = torch.cat([p["bias"] for p in parts])
        return out

    def swap_scale_shift(m):
        """AdaLayerNormContinuous's (scale, shift) as (shift, scale)."""
        w, b = m["kernel"], m["bias"]
        h = w.shape[1] // 2
        return {"kernel": torch.cat([w[:, h:], w[:, :h]], dim=1),
                "bias": torch.cat([b[h:], b[:h]])}

    def zero_lin(d_in, d_out):
        return {"kernel": torch.zeros(d_in, d_out, dtype=dtype),
                "bias": torch.zeros(d_out, dtype=dtype)}

    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("transformer_blocks."))
    dual_idx = [i for i in range(n_blocks) if f"transformer_blocks.{i}.attn2.to_q.weight" in sd]
    if dual_idx != list(range(len(dual_idx))):
        raise ValueError(f"dual-attention blocks at {dual_idx}: only the published "
                         "contiguous-prefix layout is implemented")
    blocks, blocks_dual = [], []
    for i in range(n_blocks):
        b = f"transformer_blocks.{i}"
        hidden = get(f"{b}.attn.to_q.weight").shape[0]
        if f"{b}.attn.to_add_out.weight" not in sd:  # context_pre_only
            kv = fused3(f"{b}.attn.add_k_proj", f"{b}.attn.add_k_proj",
                        f"{b}.attn.add_v_proj")
            kv["kernel"][:, :hidden] = 0
            kv["bias"][:hidden] = 0
            cont = swap_scale_shift(lin(f"{b}.norm1_context.linear"))
            zeros = zero_lin(hidden, 4 * hidden)  # the gate and the three MLP chunks
            c_mod = {"kernel": torch.cat([cont["kernel"], zeros["kernel"]], dim=1),
                     "bias": torch.cat([cont["bias"], zeros["bias"]])}
            mlp = get(f"{b}.ff.net.0.proj.weight").shape[0]
            context = {"c_qkv": kv, "c_mod": c_mod, "c_out": zero_lin(hidden, hidden),
                       "c_fc1": zero_lin(hidden, mlp), "c_fc2": zero_lin(mlp, hidden)}
        else:
            context = {"c_qkv": fused3(f"{b}.attn.add_q_proj", f"{b}.attn.add_k_proj",
                                       f"{b}.attn.add_v_proj"),
                       "c_mod": lin(f"{b}.norm1_context.linear"),
                       "c_out": lin(f"{b}.attn.to_add_out"),
                       "c_fc1": lin(f"{b}.ff_context.net.0.proj"),
                       "c_fc2": lin(f"{b}.ff_context.net.2")}
        x_mod = lin(f"{b}.norm1.linear")
        if i < len(dual_idx):
            dual = {"x_mod2": {"kernel": x_mod["kernel"][:, 6 * hidden:],
                               "bias": x_mod["bias"][6 * hidden:]},
                    "x2_qkv": fused3(f"{b}.attn2.to_q", f"{b}.attn2.to_k",
                                     f"{b}.attn2.to_v"),
                    "x2_out": lin(f"{b}.attn2.to_out.0")}
            if f"{b}.attn2.norm_q.weight" in sd:
                dual["x2_qnorm"] = get(f"{b}.attn2.norm_q.weight")
                dual["x2_knorm"] = get(f"{b}.attn2.norm_k.weight")
            blocks_dual.append(dual)
            x_mod = {"kernel": x_mod["kernel"][:, :6 * hidden],
                     "bias": x_mod["bias"][:6 * hidden]}
        block = {"x_mod": x_mod,
                 "x_qkv": fused3(f"{b}.attn.to_q", f"{b}.attn.to_k", f"{b}.attn.to_v"),
                 "x_out": lin(f"{b}.attn.to_out.0"),
                 "x_fc1": lin(f"{b}.ff.net.0.proj"), "x_fc2": lin(f"{b}.ff.net.2"),
                 **context}
        if f"{b}.attn.norm_q.weight" in sd:  # SD3.5's qk_norm
            block["x_qnorm"] = get(f"{b}.attn.norm_q.weight")
            block["x_knorm"] = get(f"{b}.attn.norm_k.weight")
            block["c_knorm"] = get(f"{b}.attn.norm_added_k.weight")
            block["c_qnorm"] = (get(f"{b}.attn.norm_added_q.weight")
                                if f"{b}.attn.norm_added_q.weight" in sd
                                else torch.ones_like(block["x_qnorm"]))
        blocks.append(block)
    pw = sd["pos_embed.proj.weight"]  # conv [hidden, C, ps, ps]
    tree = {
        "proj_in": {"kernel": pw.permute(2, 3, 1, 0).reshape(-1, pw.shape[0]),
                    "bias": sd["pos_embed.proj.bias"]},
        "ctx_in": lin("context_embedder"),
        "t_fc1": lin("time_text_embed.timestep_embedder.linear_1"),
        "t_fc2": lin("time_text_embed.timestep_embedder.linear_2"),
        "pool_fc1": lin("time_text_embed.text_embedder.linear_1"),
        "pool_fc2": lin("time_text_embed.text_embedder.linear_2"),
        "final_mod": swap_scale_shift(lin("norm_out.linear")),
        "final_out": lin("proj_out"),
        "blocks": blocks,
    }
    if blocks_dual:
        tree["blocks_dual"] = blocks_dual
    return _map_leaves(lambda t: _layout(t.to(dtype)), tree)


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


# ---------------------------------------------------------------------------
# on-disk cache of converted trees (JAX weights.py save_params / load_params)
# ---------------------------------------------------------------------------

# the archive's reserved leaf names, the JAX package's: a QuantizedTensor's
# payload, float32 scale and (compute dtype, payload dtype, channel_tile)
# record; a bf16 or fp8 leaf's raw bytes and dtype name (numpy has neither
# dtype, so both are stored as uint8 bytes and viewed back on load)
_QT_PAYLOAD, _QT_SCALE, _QT_DTYPES = "__wq__", "__wqs__", "__wqd__"
_RAW_VALUE, _RAW_DTYPE = "__wqr__", "__wqrd__"
_RAW_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
_LOAD_DTYPES = {**_TORCH_DTYPES, "float8_e4m3fn": torch.float8_e4m3fn,
                "int8": torch.int8}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _host_array(t: torch.Tensor):
    """``(array, raw dtype name or None)``: a CPU tensor as numpy in logical
    C order, a bf16 or fp8 one as its uint8 bytes (the last axis holds each
    element's bytes, as numpy's ``view(np.uint8)`` of the JAX package)."""
    t = t.detach().cpu().clone(memory_format=torch.contiguous_format)
    if t.dtype in _RAW_DTYPES.values():
        return t.view(torch.uint8).numpy(), _dtype_name(t.dtype)
    return t.numpy(), None


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}."))
    elif isinstance(tree, QuantizedTensor):
        payload, _ = _host_array(tree.payload)
        flat[f"{prefix}{_QT_PAYLOAD}"] = payload
        flat[f"{prefix}{_QT_SCALE}"] = _host_array(tree.scale.float())[0]
        flat[f"{prefix}{_QT_DTYPES}"] = np.array(
            [_dtype_name(tree.dtype), _dtype_name(tree.payload.dtype),
             str(tree.channel_tile)])
    else:
        v, raw = _host_array(torch.as_tensor(tree))
        if raw is not None:
            flat[f"{prefix}{_RAW_VALUE}"] = v
            flat[f"{prefix}{_RAW_DTYPE}"] = np.array(raw)
        else:
            flat[prefix[:-1]] = v
    return flat


def save_params(path: str, tree) -> None:
    """Cache a port tree as one flat ``.npz`` -- quantized trees included
    (int8 / fp8 payloads and float32 scales in the same archive), so that
    conversion and quantization run once.  A leaf's compute policy is not
    saved, as in the JAX package: ``set_quant_compute`` (or the pipeline's
    ``quant_compute``) applies one after the load."""
    np.savez(path, **_flatten(tree))


def _restore(tree, dtype: torch.dtype):
    """Nested archive dicts -> the port's tree in its memory layout, the
    one ``params_from_jax`` gives: a conv payload or kernel (4-D) in
    channels_last, a linear payload column-major, everything else
    contiguous; dense leaves cast to ``dtype``, a quantized leaf's payload
    and scale kept."""
    if isinstance(tree, list):
        return [_restore(v, dtype) for v in tree]
    if isinstance(tree, dict):
        if _QT_PAYLOAD in tree:
            names = [str(x) for x in tree[_QT_DTYPES]]
            payload = torch.from_numpy(np.array(tree[_QT_PAYLOAD]))
            pdt = _LOAD_DTYPES[names[1]]
            if payload.dtype != pdt:  # fp8: its uint8 bytes
                payload = payload.view(pdt)
            scale = torch.from_numpy(np.array(tree[_QT_SCALE], np.float32))
            if payload.dim() == 4:  # the scale [O, kh, kw] from its [kh, kw, O] copy
                payload = _conv_layout(payload)
                scale = _c_order(scale.permute(1, 2, 0)).permute(2, 0, 1).contiguous()
            else:
                payload = payload.t().contiguous().t()
            return QuantizedTensor(payload, scale, _LOAD_DTYPES[names[0]],
                                   channel_tile=int(names[2]) if len(names) > 2 else 1)
        if _RAW_VALUE in tree:
            raw = torch.from_numpy(np.array(tree[_RAW_VALUE]))
            return _conv_layout(raw.view(_RAW_DTYPES[str(tree[_RAW_DTYPE])]).to(dtype))
        return {k: _restore(v, dtype) for k, v in tree.items()}
    return _conv_layout(torch.from_numpy(np.array(tree)).to(dtype))


def _conv_layout(t: torch.Tensor) -> torch.Tensor:
    """A reloaded leaf in the layout ``params_from_jax`` gives it: a 4-D
    one (a conv kernel or payload, OIHW) channels_last from its HWIO copy,
    whose strides a kernel of 1 x 1 keeps; anything else contiguous."""
    if t.dim() != 4:
        return t.contiguous()
    return _layout(_c_order(t.permute(2, 3, 1, 0)).permute(3, 2, 0, 1))


def _c_order(t: torch.Tensor) -> torch.Tensor:
    """A copy with the strides numpy gives a C-order array (its size-1 dims
    included, which ``contiguous`` leaves as they were)."""
    return t.clone(memory_format=torch.contiguous_format)


def load_params(path: str, dtype=None):
    """Load a `save_params` archive back into a port tree.

    A dense archive casts to ``dtype`` (default float32).  A quantized
    archive's compute dtype comes from the archive -- the scales were
    baked against it -- and the whole tree (norms, biases, embeddings
    included) takes it; an explicit ``dtype`` that disagrees raises, and so
    does an archive that mixes compute dtypes, as the JAX package's
    ``load_params`` refuses them.  Leaves land on the CPU in the port's
    layout; stacked layers come back as lists."""
    tree: Dict[str, Any] = {}
    recorded = set()
    with np.load(path) as data:
        for key in data.files:
            parts = key.split(".")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
            if parts[-1] == _QT_DTYPES:
                recorded.add(str(data[key][0]))
    if recorded:
        if len(recorded) > 1:
            raise ValueError(
                f"quantized archive {path!r} mixes compute dtypes {sorted(recorded)}")
        archived = _LOAD_DTYPES[recorded.pop()]
        if dtype is not None and dtype != archived:
            raise ValueError(
                f"load_params(dtype={_dtype_name(dtype)!r}) on a quantized archive "
                f"with compute dtype {_dtype_name(archived)!r}: the per-tile scales "
                "were baked against the archived dtype — rebuild from the dense "
                "weights to change compute dtype")
        dtype = archived
    return _restore(_listify(tree), dtype or torch.float32)
