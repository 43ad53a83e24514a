"""PyTorch port: the ``"flops"`` key of ``comm_volume_report(per_phase=True)``
(ROADMAP item 10, ``DenoiseRunner._flop_estimate``) and the
``cli/profile_macs.py`` counter (item 9).

* The tiny SDXL UNet under the step cache (interval 2, depth 1): the full
  and the shallow evaluation's counts equal the closed-form count of their
  convolutions, GEMMs and attention products, exactly (the text KV is
  computed once a generation, outside the step); at a world of two ranks
  (CFG split) each rank counts half.
* With the step cache off the key is None, as tests/test_stepcache.py
  asserts of the JAX package; off the displaced patch path the report is
  ``{"phases": {}, "bytes": {}, "flops": None}``.
* ``shallow_ratio`` against the JAX package's ``_flop_estimate`` (XLA's
  cost analysis, which counts elementwise work too) on the same tiny
  config: within ``RATIO_TOL`` (measured 0.0092: the port 0.2702 of
  343416832, the JAX package 0.2610 of 336905152 on one device).
* ``python -m distrifuser_tpu_torch.cli.profile_macs --model tiny`` prints
  one line a resolution.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.utils import config as config_mod

RATIO_TOL = 0.02
CACHE = {"step_cache_interval": 2, "step_cache_depth": 1}


def _runner(**fields):
    from distrifuser_tpu_torch import DistriConfig
    from distrifuser_tpu_torch.parallel.runner import make_runner
    from distrifuser_tpu_torch.schedulers import get_scheduler

    ucfg = port_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = port_unet.init_unet_params(torch.Generator().manual_seed(0), ucfg)
    cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1, **fields)
    return make_runner(cfg, ucfg, params, get_scheduler("ddim")), ucfg, params


def _closed_form(params, cfg, b, h, w, depth, shallow):
    """2 x multiply-adds of every conv, GEMM and attention product one
    evaluation of the tiny UNet runs on ``b`` latents of h x w (the step
    cache's shallow evaluation: down blocks below the cut without the last
    one's downsampler, the up blocks from ``depth`` on)."""
    levels = len(cfg.block_out_channels)
    cut = levels - depth
    pixels = [b * (h >> i) * (w >> i) for i in range(levels)]
    total = 0

    def runs(path):
        if not shallow or path[0] in ("conv_in", "conv_out", "time_embedding",
                                      "add_embedding"):
            return True
        if path[0] == "down_blocks":
            i = int(path[1])
            return i < cut and not (i == cut - 1 and path[2] == "downsamplers")
        return path[0] == "up_blocks" and int(path[1]) >= depth

    def level(path):
        if path[0] == "down_blocks":
            return int(path[1]) + (path[2] == "downsamplers")
        if path[0] == "mid_block":
            return levels - 1
        if path[0] == "up_blocks":
            return levels - 1 - int(path[1]) - (path[2] == "upsamplers")
        return 0

    def walk(node, path):
        nonlocal total
        if isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
            return
        if not isinstance(node, dict):
            return
        if "attn1" in node and runs(path):  # a transformer block's two products
            c, lq = node["attn1"]["to_q"]["kernel"].shape[1], pixels[level(path)] // b
            total += 4 * b * lq * lq * c + 4 * b * lq * 77 * c
        for k, v in node.items():
            p = path + (k,)
            if k != "kernel":
                walk(v, p)
            elif runs(p) and not ("attn2" in p and p[-2] == "to_kv"):  # text KV: once
                if v.dim() == 4:
                    cout, cin, kh, kw = v.shape
                    total += 2 * pixels[level(p)] * cout * cin * kh * kw
                else:
                    per_image = "time_emb_proj" in p or p[0] in ("time_embedding",
                                                                 "add_embedding")
                    total += 2 * (b if per_image else pixels[level(p)]) * v.shape[0] * v.shape[1]

    walk(params, ())
    return total


def test_flops_equal_the_closed_form_count():
    runner, ucfg, params = _runner(**CACHE)
    got = runner._flop_estimate()
    b = 2  # one image, both CFG branches: the image group's dense evaluation
    full = _closed_form(params, ucfg, b, 16, 16, 1, shallow=False)
    shallow = _closed_form(params, ucfg, b, 16, 16, 1, shallow=True)
    assert got == {"full": full, "shallow": shallow, "shallow_ratio": shallow / full}


def test_flops_of_a_rank_are_its_share(monkeypatch):
    """At a world of two ranks under the CFG split each rank evaluates
    one branch's rows: half the image group's count."""
    one, _, _ = _runner(**CACHE)
    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (2, 0))
    monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: (None, None, None))
    two, _, _ = _runner(**CACHE)
    want = one._flop_estimate()
    assert two.cfg.group_size == 2
    assert two._flop_estimate() == {"full": want["full"] / 2, "shallow": want["shallow"] / 2,
                                    "shallow_ratio": want["shallow_ratio"]}


def test_report_carries_flops_and_none_without_the_cache():
    lat = torch.from_numpy(np.random.RandomState(0).randn(1, 16, 16, 4).astype(np.float32))
    enc = torch.zeros(2, 1, 77, 32)
    added = {"text_embeds": torch.zeros(2, 1, 32), "time_ids": torch.zeros(2, 1, 6)}
    for fields, want_none in ((CACHE, False), ({}, True)):
        runner, _, _ = _runner(**fields)
        runner.generate(lat, enc, added_cond=added, num_inference_steps=4, guidance_scale=5.0)
        rep = runner.comm_volume_report(per_phase=True)
        if want_none:
            assert rep["flops"] is None
        else:
            assert rep["flops"] == runner._flop_estimate()
            assert 0 < rep["flops"]["shallow_ratio"] < 0.7
    tensor, _, _ = _runner(parallelism="tensor")
    assert tensor.comm_volume_report(per_phase=True) == {"phases": {}, "bytes": {},
                                                          "flops": None}


def test_shallow_ratio_matches_jax(devices8):
    from distrifuser_tpu import DistriConfig as JaxDistriConfig
    from distrifuser_tpu.models.unet import tiny_config
    from distrifuser_tpu.parallel.runner import make_runner as make_jax_runner
    from distrifuser_tpu.schedulers import get_scheduler
    from test_torch_port_ranks import jax_layout

    runner, _, params = _runner(**CACHE)
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128, warmup_steps=1,
                           **CACHE)
    jrunner = make_jax_runner(jcfg, tiny_config(cross_attention_dim=32, sdxl=True),
                              jax_layout(params), get_scheduler("ddim"))
    want = jrunner._flop_estimate()
    got = runner._flop_estimate()
    assert want is not None
    assert abs(got["shallow_ratio"] - want["shallow_ratio"]) <= RATIO_TOL, (got, want)


def test_profile_macs_cli_prints_a_line_a_size():
    out = subprocess.run(
        [sys.executable, "-m", "distrifuser_tpu_torch.cli.profile_macs", "--model", "tiny",
         "--image_size", "128", "256", "--dtype", "float32"],
        capture_output=True, text=True, timeout=300, check=True).stdout.splitlines()
    assert [line.split(":")[0] for line in out] == ["tiny @ 128x128", "tiny @ 256x256"]
    gflops = [float(line.split(": ")[1].split(" GFLOPs")[0]) for line in out]
    assert 0 < gflops[0] < gflops[1]


@pytest.mark.parametrize("size", [128])
def test_profile_macs_count_is_the_dense_forward(size):
    """The CLI's count of the tiny preset (no CFG, one latent) is the
    closed form of its whole forward, the cross-attention's text KV
    included."""
    from distrifuser_tpu_torch.cli.profile_macs import unet_flops

    flops, _, _ = unet_flops("tiny", size, 1, torch.float32)
    ucfg = port_unet.tiny_config()
    params = port_unet.init_unet_params(torch.Generator().manual_seed(0), ucfg)
    kv = sum(2 * 77 * blk["attn2"]["to_kv"]["kernel"].shape[0]
             * blk["attn2"]["to_kv"]["kernel"].shape[1]
             for blk in _transformer_blocks(params))
    assert flops == _closed_form(params, ucfg, 1, size // 8, size // 8, 1, False) + kv


def _transformer_blocks(node):
    if isinstance(node, dict):
        if "attn1" in node:
            yield node
            return
        for v in node.values():
            yield from _transformer_blocks(v)
    elif isinstance(node, list):
        for v in node:
            yield from _transformer_blocks(v)
