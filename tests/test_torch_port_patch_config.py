"""PyTorch port: the three repaired pipeline and config faults, the config's
refusals of what is not ported yet, and the device a rank takes.

Repairs, each of a test that failed before it:
* the per-step callback of a tail chunk sees only the chunk's real rows
  (``batch_size=2`` with 3 images: [2, ...], then [1, ...]);
* a CUDA device with a dtype other than bf16 is refused at config time
  (the card's kernels are bf16 only) instead of failing at the first
  attention;
* the UNet family decodes ``latent / scaling`` with no VAE shift.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
from distrifuser_tpu_torch.models import clip, unet, vae
from distrifuser_tpu_torch.utils import config as config_mod
from distrifuser_tpu_torch.utils import env


def _tiny_pipeline(vcfg=None, **cfg_fields):
    gen = torch.Generator().manual_seed(0)
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    vcfg = vcfg or vae.tiny_vae_config()
    tcfgs = [clip.tiny_clip_config(hidden=16),
             clip.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=32,
                                 projection_dim=32)]
    cfg = DistriConfig(device="cpu", height=128, width=128, **cfg_fields)
    return DistriSDXLPipeline.from_params(
        cfg, ucfg, unet.init_unet_params(gen, ucfg), vcfg,
        vae.init_vae_params(torch.Generator().manual_seed(1), vcfg), tcfgs,
        [clip.init_clip_params(gen, tc) for tc in tcfgs])


def test_callback_sees_only_real_rows_of_tail_chunk():
    pipe = _tiny_pipeline(batch_size=2)
    seen = []
    out = pipe("a red boat", num_images_per_prompt=3, num_inference_steps=1,
               output_type="latent",
               callback=lambda i, t, x: seen.append((i, tuple(x.shape))))
    assert seen == [(0, (2, 16, 16, 4)), (0, (1, 16, 16, 4))]
    assert len(out.images) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_non_bf16_dtype_refused_on_card(dtype):
    with pytest.raises(ValueError, match="queue 3 fault 2.*queue 2 item 4"):
        DistriConfig(device="cuda", dtype=dtype)
    assert DistriConfig(device="cpu", dtype=dtype).dtype == dtype


def test_unet_family_decodes_without_vae_shift():
    latents = np.random.RandomState(2).randn(1, 16, 16, 4).astype(np.float32)
    images = []
    for shift in (0.0, 0.5):
        vcfg = dataclasses.replace(vae.tiny_vae_config(), shift_factor=shift)
        pipe = _tiny_pipeline(vcfg)
        images.append(pipe("a red boat", latents=latents, num_inference_steps=1,
                           output_type="np").images[0])
    np.testing.assert_array_equal(images[0], images[1])


@pytest.mark.parametrize("field,value,item", [
    ("attn_impl", "usp", None),
    ("attn_impl", "ulysses", None),
    ("pipe_patches", 4, "no pipeline to stream patches through"),
])
def test_unported_knobs_refused(field, value, item):
    """The DiT's head-sharded layouts and PipeFusion's ``pipe_patches``,
    ported since, are accepted; ``pipe_patches`` only under
    ``parallelism="pipefusion"``: at the default "patch" it is the JAX
    config's ValueError."""
    if item is None:
        assert getattr(DistriConfig(device="cpu", **{field: value}), field) == value
        return
    with pytest.raises(ValueError, match=item):
        DistriConfig(device="cpu", **{field: value})
    cfg = DistriConfig(device="cpu", parallelism="pipefusion", **{field: value})
    assert getattr(cfg, field) == value


@pytest.mark.parametrize("fields", [
    {"attn_impl": "ring"},
    {"comm_batch": True},
    {"comm_compress": "int8"},
    {"refresh_fraction": 0.5},
    {"step_cache_interval": 2, "step_cache_depth": 1},
])
def test_ported_comm_knobs_accepted(fields):
    cfg = DistriConfig(device="cpu", **fields)
    for name, value in fields.items():
        assert getattr(cfg, name) == value


@pytest.mark.parametrize("parallelism", ["tensor", "naive_patch"])
def test_other_parallelisms_dispatch_across_ranks(monkeypatch, parallelism):
    """At world 2 without the CFG split both parallelisms build, and the
    runner picks their dispatch: naive patch the dense UNet on this rank's
    slice (``is_sp``, no patch state), tensor parallelism ``TPDispatch``
    over this rank's shard of the heads."""
    from distrifuser_tpu_torch.models.unet import DenseDispatch
    from distrifuser_tpu_torch.models.unet_tp import TPDispatch
    from distrifuser_tpu_torch.parallel.runner import make_runner
    from distrifuser_tpu_torch.schedulers import get_scheduler

    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (2, 1))
    monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: ("batch", None, None))
    cfg = DistriConfig(device="cpu", height=128, width=128, split_batch=False,
                       parallelism=parallelism)
    assert cfg.n_device_per_batch == 2 and cfg.split_idx() == 1
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = unet.init_unet_params(torch.Generator().manual_seed(0), ucfg)
    runner = make_runner(cfg, ucfg, params, get_scheduler("ddim"))
    dispatch = runner.dispatch({})
    if parallelism == "naive_patch":
        assert cfg.is_sp and isinstance(dispatch, DenseDispatch)
        assert runner.params is params and runner._phases(3) == ["row"] * 3
    else:
        assert not cfg.is_sp and isinstance(dispatch, TPDispatch)
        assert (dispatch.n, dispatch.idx, dispatch.group) == (2, 1, "batch")
        q = runner.params["down_blocks"][1]["attentions"][0]["transformer_blocks"][0]
        assert q["attn1"]["to_q"]["kernel"].shape == (64, 32)  # 2 of 4 heads
        assert runner._phases(3) == ["sync"] * 3


def test_rank_layout_at_world_4(monkeypatch):
    """World 4: sp 4 without the CFG split, CFG 2 x sp 2 with it (rank r
    has batch_idx r // n and split_idx r % n)."""
    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (4, 3))
    monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: ("batch", None, None))
    cfg = DistriConfig(device="cpu", height=256, width=256, split_batch=False)
    assert (cfg.n_device_per_batch, cfg.batch_idx(), cfg.split_idx()) == (4, 0, 3)
    assert not cfg.cfg_split and cfg.is_sp
    cfg = DistriConfig(device="cpu", height=256, width=256)
    assert (cfg.n_device_per_batch, cfg.batch_idx(), cfg.split_idx()) == (2, 1, 1)
    assert cfg.cfg_split and [cfg.batch_idx(r) for r in range(4)] == [0, 0, 1, 1]


def test_runner_refuses_rows_that_do_not_split(monkeypatch):
    """At sp 4 the tiny UNet's latent rows must split into 4 patches that
    stay whole after its one downsample: 12 rows do not, 16 do."""
    from distrifuser_tpu_torch.parallel.runner import DenoiseRunner
    from distrifuser_tpu_torch.schedulers import get_scheduler

    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (4, 0))
    monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: ("batch", None, None))
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    for height, ok in ((96, False), (128, True)):
        cfg = DistriConfig(device="cpu", height=height, width=128, split_batch=False)
        if ok:
            DenoiseRunner(cfg, ucfg, {}, get_scheduler("ddim"))
        else:
            with pytest.raises(ValueError, match="divisible by n_devices"):
                DenoiseRunner(cfg, ucfg, {}, get_scheduler("ddim"))


@pytest.mark.parametrize("rank,local,cards,want", [
    (3, None, 1, "cuda:0"), (3, None, 4, "cuda:3"), (5, "1", 4, "cuda:1"),
    (6, None, 4, "cuda:2")])
def test_rank_takes_the_card_of_its_local_rank(monkeypatch, rank, local, cards, want):
    picked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    if local is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local)
    assert env.resolve_device(None, rank) == torch.device(want)
    assert picked == [torch.device(want)]


# ROADMAP queue 3 fault 5: keywords the JAX package accepts raised TypeError
@pytest.mark.parametrize("fields", [
    {"hybrid_loop": True},
    {"hybrid_loop": False, "step_cache_interval": 2, "step_cache_depth": 1},
    {"hybrid_loop": True, "step_cache_interval": 2, "step_cache_depth": 1},
    {"ulysses_degree": 1},
    {"ulysses_degree": 2},
    {"ulysses_degree": 0},
    {"pipe_patches": None},
    {"pipe_patches": 4},
    {"pipe_patches": 0},
    {"pipe_patches": 4, "parallelism": "pipefusion"},
    {"pipe_patches": 0, "parallelism": "pipefusion"},
    {"parallelism": "pipefusion", "comm_compress": "int8_residual"},
    {"parallelism": "pipefusion", "step_cache_interval": 2, "step_cache_depth": 1},
])
def test_jax_config_keywords_accepted_or_refused_alike(fields):
    """Each keyword is accepted or refused as the JAX package's DistriConfig
    accepts or refuses it, with the same exception type (``pipe_patches``
    too, accepted under PipeFusion only), and carries ``hybrid_loop`` with
    no effect."""
    from distrifuser_tpu.utils.config import DistriConfig as JaxDistriConfig

    try:
        JaxDistriConfig(**fields)
        jax_error = None
    except (ValueError, NotImplementedError) as e:
        jax_error = type(e)
    if jax_error is None:
        cfg = DistriConfig(device="cpu", **fields)
        for name, value in fields.items():
            assert getattr(cfg, name) == value
        return
    with pytest.raises((ValueError, NotImplementedError)) as got:
        DistriConfig(device="cpu", **fields)
    assert got.type is jax_error
    if fields.get("hybrid_loop") and "step_cache_interval" in fields:
        assert "hybrid_loop" in str(got.value)


def test_set_progress_bar_config_is_a_no_op():
    """The reference's scripts call it on both pipelines; the JAX package
    keeps it as a no-op (``distrifuser_tpu/pipelines.py``)."""
    from distrifuser_tpu_torch import DistriSDPipeline

    pipe = _tiny_pipeline()
    assert pipe.set_progress_bar_config(disable=True) is None
    assert DistriSDPipeline.set_progress_bar_config is DistriSDXLPipeline.set_progress_bar_config
