"""Tensor parallelism: head-sharded attention, GEGLU TP, channel-sharded ResNet.

Counterpart of distrifuser_tpu/models/unet_tp.py (``prepare_tp_params``,
``tp_attention``, ``tp_feed_forward``, ``tp_resnet``, ``tp_conv``,
``TPDispatch``, ``head_dim_table``), after the reference's TP modules
(modules/tp/{attention,feed_forward,conv2d,resnet}.py).  Each rank of the
``batch_group`` holds the whole activation and its shard of the weights;
every sharded block computes a partial result and all-reduces it over the
group, the bias added once after the reduce:

* attention: this rank's heads of q, k and v and the matching rows of the
  output projection.  Head counts that do not divide n are zero-padded to
  a whole number of heads a rank, as in the JAX package: a padded head has
  zero q, k, v and output rows and adds exactly zero to the sum;
* GEGLU: this rank's columns of the value and gate halves, and the rows of
  the output projection;
* ResNet: conv1, its bias, ``time_emb_proj`` and norm2 sharded over the
  middle channels (norm2 over this rank's groups), conv2 over its input
  channels; norm1 and the shortcut replicated;
* the samplers' convs and ``conv_out``: sharded over input channels.

``prepare_tp_params`` returns one rank's tree in the port's layout: the
fused ``to_kv`` and GEGLU projections stay fused as [this rank's K | its V]
and [value | gate], so that ``split_kv`` and ``geglu`` run unchanged; conv
kernels are OIHW in channels_last memory format.  The JAX package keeps the
whole padded tree with a sharding spec; its shard of rank r equals this
tree.  There is no staleness: TP is exact at every step, so its output
equals the dense UNet's up to the order of the sums.  The CFG branches are
combined by the runner's gather over the ``split_group``, which avoids the
reference's TP CFG-gather bug by construction (SURVEY §2.6).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.attention import sdpa, split_kv
from ..ops.conv import conv2d
from ..ops.linear import linear
from ..ops.normalization import group_norm
from ..parallel.collectives import psum
from .unet import UNetConfig, silu

# ---------------------------------------------------------------------------
# parameter sharding
# ---------------------------------------------------------------------------


def _pad_to(x, target: int, dim: int):
    pad = target - x.shape[dim]
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def _part(x, n: int, idx: int, dim: int):
    """Rank ``idx``'s contiguous n-th of ``x`` along ``dim``, as its own
    tensor (conv kernels channels_last)."""
    part = x.chunk(n, dim=dim)[idx]
    if part.dim() == 4:
        return part.contiguous(memory_format=torch.channels_last).clone(
            memory_format=torch.channels_last)
    return part.contiguous().clone()


def _shard_attn(p, heads: int, n: int, idx: int):
    """Projections of ``heads`` heads, zero-padded to a multiple of n heads:
    this rank's q columns, K and V columns (fused), output rows."""
    c_q = p["to_q"]["kernel"].shape[1]
    cp = math.ceil(heads / n) * n * (c_q // heads)
    k_w, v_w = split_kv(p["to_kv"]["kernel"])
    kv = torch.cat([_part(_pad_to(w, cp, 1), n, idx, 1) for w in (k_w, v_w)], dim=1)
    return {
        "to_q": {"kernel": _part(_pad_to(p["to_q"]["kernel"], cp, 1), n, idx, 1)},
        "to_kv": {"kernel": kv},
        "to_out": {"kernel": _part(_pad_to(p["to_out"]["kernel"], cp, 0), n, idx, 0),
                   "bias": p["to_out"]["bias"]},
    }


def _shard_ff(p, n: int, idx: int):
    proj = p["net_0"]["proj"]
    inner = proj["kernel"].shape[1] // 2
    if inner % n:
        raise ValueError(f"GEGLU inner dim {inner} not divisible by {n}")

    def halves(w, dim):
        a, g = w.chunk(2, dim=dim)
        return torch.cat([_part(a, n, idx, dim), _part(g, n, idx, dim)], dim=dim)

    new_proj = {"kernel": halves(proj["kernel"], 1)}
    if "bias" in proj:
        new_proj["bias"] = halves(proj["bias"], 0)
    return {"net_0": {"proj": new_proj},
            "net_2": {"kernel": _part(p["net_2"]["kernel"], n, idx, 0),
                      "bias": p["net_2"]["bias"]}}


def _shard_resnet(p, n: int, idx: int):
    """conv1 and time_emb_proj out-sharded, norm2 group-sharded, conv2
    in-sharded; norm1 and conv_shortcut replicated (tp/resnet.py:18-104)."""
    new = dict(p)
    new["conv1"] = {"kernel": _part(p["conv1"]["kernel"], n, idx, 0),
                    "bias": _part(p["conv1"]["bias"], n, idx, 0)}
    new["time_emb_proj"] = {"kernel": _part(p["time_emb_proj"]["kernel"], n, idx, 1),
                            "bias": _part(p["time_emb_proj"]["bias"], n, idx, 0)}
    new["norm2"] = {k: _part(v, n, idx, 0) for k, v in p["norm2"].items()}
    new["conv2"] = {"kernel": _part(p["conv2"]["kernel"], n, idx, 1),
                    "bias": p["conv2"]["bias"]}
    return new


def _shard_conv_in_channels(p, n: int, idx: int):
    """Input-channel-sharded conv (conv_out, samplers; tp/conv2d.py:37-57)."""
    new = {"kernel": _part(p["kernel"], n, idx, 1)}
    if "bias" in p:
        new["bias"] = p["bias"]
    return new


def prepare_tp_params(params, ucfg: UNetConfig, n: int, idx: int):
    """Rank ``idx``'s tree of an n-way tensor-parallel UNet, walking the
    dense tree by path (the reference's surgery targets,
    distri_sdxl_unet_tp.py:20-38)."""

    def walk(tree, path):
        if isinstance(tree, list):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(tree)]
        if not isinstance(tree, dict):
            raise TypeError(f"unexpected leaf container at {path}")
        leaf = path.rsplit(".", 1)[-1]
        if leaf in ("attn1", "attn2"):
            return _shard_attn(tree, _heads_from_path(path, ucfg), n, idx)
        if leaf == "ff":
            return _shard_ff(tree, n, idx)
        if ".resnets." in f"{path}." and leaf.isdigit() and "time_emb_proj" in tree:
            return _shard_resnet(tree, n, idx)
        if (leaf == "conv" and ("downsamplers" in path or "upsamplers" in path)
                or path == "conv_out"):
            return _shard_conv_in_channels(tree, n, idx)
        return {k: walk(v, f"{path}.{k}" if path else k)
                if isinstance(v, (dict, list)) else v for k, v in tree.items()}

    return walk(params, "")


def _heads_from_path(path: str, ucfg: UNetConfig) -> int:
    parts = path.split(".")
    last = len(ucfg.block_out_channels) - 1
    if parts[0] == "mid_block":
        return ucfg.num_attention_heads[last]
    block_idx = int(parts[1])
    if parts[0] == "down_blocks":
        return ucfg.num_attention_heads[block_idx]
    assert parts[0] == "up_blocks"
    return ucfg.num_attention_heads[last - block_idx]


# ---------------------------------------------------------------------------
# TP compute: local partials, one all-reduce a block, bias after it
# ---------------------------------------------------------------------------


def tp_attention(p, x, *, head_dim: int, group=None, encoder_hidden_states=None):
    """This rank's heads, their output rows, all-reduce, bias
    (tp/attention.py:150-161)."""
    enc = x if encoder_hidden_states is None else encoder_hidden_states
    q = linear(p["to_q"], x)
    k, v = split_kv(linear(p["to_kv"], enc))
    out = sdpa(q, k, v, heads=q.shape[-1] // head_dim)
    out = psum(linear({"kernel": p["to_out"]["kernel"]}, out), group)
    return out + p["to_out"]["bias"]


def tp_feed_forward(p, x, *, group=None):
    """Column-sharded GEGLU, row-sharded output, all-reduce, bias
    (tp/feed_forward.py:63-83)."""
    a, g = linear(p["net_0"]["proj"], x).chunk(2, dim=-1)
    act = a * F.gelu(g, approximate="none")
    y = psum(linear({"kernel": p["net_2"]["kernel"]}, act), group)
    return y + p["net_2"]["bias"]


def tp_resnet(p, x, temb, *, groups: int, n: int, group=None):
    """Mid-channel-sharded ResnetBlock2D with one all-reduce after conv2
    (tp/resnet.py:117-202)."""
    h = group_norm(p["norm1"], x, groups=groups)
    h = conv2d(p["conv1"], silu(h))  # this rank's middle channels
    t = linear(p["time_emb_proj"], silu(temb))
    h = h + t[:, None, None, :]
    h = group_norm(p["norm2"], h, groups=groups // n)  # this rank's groups
    y = psum(conv2d({"kernel": p["conv2"]["kernel"]}, silu(h)), group)
    y = y + p["conv2"]["bias"]
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x)
    return x + y


def tp_conv(p, x, *, idx: int, n: int, stride: int = 1, group=None):
    """This rank's input channels through its kernel shard, all-reduce,
    bias (tp/conv2d.py:37-57)."""
    x_local = x.chunk(n, dim=3)[idx]
    y = psum(conv2d({"kernel": p["kernel"]}, x_local, stride=stride), group)
    return y + p["bias"] if "bias" in p else y


class TPDispatch:
    """Plugs tensor parallelism into the shared UNet definition: rank
    ``idx`` of ``n`` in ``group``; ``head_dims`` from ``head_dim_table``
    (a padded shard no longer tells its head count).  The cross-attention
    recomputes the text KV with its sharded kernels at every step, as the
    reference's TP attention does."""

    def __init__(self, n: int, idx: int, head_dims: Dict[str, int], group=None):
        self.n, self.idx = n, idx
        self.head_dims = head_dims
        self.group = group

    def conv_in(self, p, x, name):
        return conv2d(p, x)

    def conv(self, p, x, name, *, stride=1):
        if "downsamplers" in name or "upsamplers" in name or name == "conv_out":
            return tp_conv(p, x, idx=self.idx, n=self.n, stride=stride, group=self.group)
        return conv2d(p, x, stride=stride)

    def group_norm(self, p, x, name, *, groups, eps=1e-5):
        return group_norm(p, x, groups=groups, eps=eps)

    def self_attn(self, p, x, name, *, heads):
        return tp_attention(p, x, head_dim=self.head_dims[name], group=self.group)

    def cross_attn(self, p, x, name, *, heads, enc):
        return tp_attention(p, x, head_dim=self.head_dims[name], group=self.group,
                            encoder_hidden_states=enc)

    def feed_forward(self, p, x, name):
        return tp_feed_forward(p, x, group=self.group)

    def resnet(self, p, x, temb, name, *, groups):
        return tp_resnet(p, x, temb, groups=groups, n=self.n, group=self.group)


def head_dim_table(ucfg: UNetConfig) -> Dict[str, int]:
    """Head dim (C // heads) of every attention layer, keyed like the
    forward's layer names."""
    table: Dict[str, int] = {}

    def add(prefix, level, n_attn, n_tf):
        d = ucfg.block_out_channels[level] // ucfg.num_attention_heads[level]
        for a in range(n_attn):
            for t in range(n_tf):
                for which in ("attn1", "attn2"):
                    table[f"{prefix}.{a}.transformer_blocks.{t}.{which}"] = d

    for i, btype in enumerate(ucfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            add(f"down_blocks.{i}.attentions", i, ucfg.layers_per_block,
                ucfg.transformer_layers_per_block[i])
    last = len(ucfg.block_out_channels) - 1
    add("mid_block.attentions", last, 1, ucfg.transformer_layers_per_block[-1])
    rev_tf = list(reversed(ucfg.transformer_layers_per_block))
    for i, btype in enumerate(ucfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            add(f"up_blocks.{i}.attentions", last - i, ucfg.layers_per_block + 1,
                rev_tf[i])
    return table
