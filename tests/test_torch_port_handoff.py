"""PyTorch port: the base/refiner handoff and SDXL's micro-conditioning
against the JAX package.

* ``denoising_end`` then ``denoising_start`` at the same fraction: the two
  calls equal one full run (DDIM; the port bit for bit, the JAX package
  within its own 1e-4), and the port's split equals the JAX split within
  2e-4, the pipeline tolerance, for DDIM and for DPM++ 2M, whose second
  stage starts with fresh solver history in both packages (so its split
  differs from the full run).  The callback sees the absolute step
  indices.
* The time ids, 6 for SDXL-base and 5 for a refiner-style add embedding
  (pooled 32 + 5 x 8 = 72), equal the JAX ``_encode``'s for every
  combination of the ``negative_*`` keywords, with default and with given
  positive ones, with and without CFG: exact.
* A refiner-style pipeline resumes the base pipeline's latent within 2e-4
  of the JAX package's, and ``aesthetic_score`` changes its output.
* The runner's phases count the synchronous steps from the first step
  that runs; the refusals of bad fractions and step ranges.
"""

import itertools

import numpy as np
import pytest
import torch

from distrifuser_tpu_torch.parallel import runner as runner_mod
from distrifuser_tpu_torch.utils import config as config_mod
from test_torch_port_img2img import _sdxl_pair

TOL = 2e-4
PROMPT = "a canyon at noon"
STEPS = 6
REFINER = {"projection_class_embeddings_input_dim": 72}  # pooled 32 + 5 ids x 8


def _noise(seed=2):
    return np.random.RandomState(seed).randn(1, 16, 16, 4).astype(np.float32)


@pytest.mark.parametrize("scheduler", ("ddim", "dpm-solver"))
def test_split_matches_full_run_and_jax(devices8, scheduler):
    jpipe, port = _sdxl_pair(devices8, scheduler)
    pipe = port()
    kw = dict(num_inference_steps=STEPS, output_type="latent")
    runs = {}
    for name, p in (("jax", jpipe), ("port", pipe)):
        full = np.asarray(p(PROMPT, latents=_noise(), **kw).images[0])
        mid = np.asarray(p(PROMPT, latents=_noise(), denoising_end=0.5, **kw).images[0])
        assert np.abs(mid - full).max() > 0  # stopped early
        seen = []
        cb = {"callback": lambda i, t, x: seen.append(i)} if name == "port" else {}
        resumed = np.asarray(p(PROMPT, latents=mid[None], denoising_start=0.5, **cb,
                               **kw).images[0])
        runs[name] = (full, mid, resumed)
        if name == "port":
            assert seen == [3, 4, 5]
            assert pipe.runner.phase_counts == {"sync": 3, "stale": 0}
    if scheduler == "ddim":  # stateless: the split replays the full trajectory
        np.testing.assert_array_equal(runs["port"][2], runs["port"][0])
        np.testing.assert_allclose(runs["jax"][2], runs["jax"][0], rtol=0, atol=1e-4)
    else:  # fresh DPM++ history at the handoff, in both packages
        assert np.abs(runs["port"][2] - runs["port"][0]).max() > 1e-3
    for got, want in zip(runs["port"], runs["jax"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the eager step gives the graphed (static-buffer) split bit for bit
    eager = port(use_cuda_graph=False)
    resumed = eager(PROMPT, latents=runs["port"][1][None], denoising_start=0.5,
                    **kw).images[0]
    np.testing.assert_array_equal(resumed, runs["port"][2])


def _combinations(cfg):
    """Every subset of the negative keywords, with default and with given
    positive ones."""
    negs = {"negative_original_size": (512, 640), "negative_crops_coords_top_left": (8, 16),
            "negative_target_size": (96, 64), "negative_aesthetic_score": 3.25}
    positives = ({}, {"original_size": (256, 192), "crops_coords_top_left": (32, 0),
                      "target_size": (cfg.height, cfg.width // 2), "aesthetic_score": 7.5})
    for pos in positives:
        for n in range(len(negs) + 1):
            for keys in itertools.combinations(negs, n):
                yield {**pos, **{k: negs[k] for k in keys}}


def _micro(mc):
    """The micro-conditioning dict ``__call__`` hands ``_encode``: every
    keyword, at its default where ``mc`` does not give it."""
    full = {"original_size": None, "crops_coords_top_left": (0, 0), "target_size": None,
            "aesthetic_score": 6.0, "negative_original_size": None,
            "negative_crops_coords_top_left": None, "negative_target_size": None,
            "negative_aesthetic_score": 2.5}
    return {**full, **mc}


@pytest.mark.parametrize("layout", ("base6", "refiner5"))
def test_time_ids_match_jax(devices8, layout):
    fields = REFINER if layout == "refiner5" else {}
    jpipe, port = _sdxl_pair(devices8, "ddim", **fields)
    pipe = port()
    n_ids = 5 if fields else 6
    for mc in _combinations(pipe.distri_config):
        _, want = jpipe._encode(["a", "b"], ["", ""], _micro(mc))
        _, got = pipe._encode(["a", "b"], ["", ""], _micro(mc))
        want = np.asarray(want["time_ids"])
        assert want.shape == (2, 2, n_ids), want.shape
        np.testing.assert_array_equal(got["time_ids"].numpy(), want, err_msg=str(mc))
    # no CFG: the positive ids alone
    from distrifuser_tpu import DistriConfig as JaxDistriConfig
    from distrifuser_tpu.pipelines import DistriSDXLPipeline as JaxSDXLPipeline

    nocfg = port(do_classifier_free_guidance=False)
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128,
                           do_classifier_free_guidance=False)
    jnocfg = JaxSDXLPipeline(jcfg, jpipe.unet_config, jpipe.runner.params,
                             jpipe.vae_config, jpipe.vae_params, jpipe.scheduler,
                             jpipe.tokenizers, jpipe.text_encoders)
    mc = _micro({"original_size": (64, 32), "negative_aesthetic_score": 1.0})
    want = np.asarray(jnocfg._encode(["a"], [""], mc)[1]["time_ids"])
    got = nocfg._encode(["a"], [""], mc)[1]["time_ids"].numpy()
    assert want.shape == (1, 1, n_ids)
    np.testing.assert_array_equal(got, want)


def test_time_ids_refuse_other_widths(devices8):
    _, port = _sdxl_pair(devices8, "ddim", projection_class_embeddings_input_dim=60)
    with pytest.raises(ValueError, match="cannot derive time ids"):
        port()._encode(["a"], [""])


def test_refiner_resumes_base_latent(devices8):
    """A base stage to 0.5, then a refiner-layout UNet (its own weights)
    from 0.5: within 2e-4 of the JAX package's; the aesthetic score
    reaches the output."""
    jbase, base = _sdxl_pair(devices8, "ddim")
    jref, ref = _sdxl_pair(devices8, "ddim", **REFINER)
    kw = dict(num_inference_steps=4, output_type="latent")
    mid = base()(PROMPT, latents=_noise(), denoising_end=0.5, **kw).images[0]
    jmid = np.asarray(jbase(PROMPT, latents=_noise(), denoising_end=0.5, **kw).images[0])
    np.testing.assert_allclose(mid, jmid, rtol=0, atol=TOL)
    refiner = ref()
    out = refiner(PROMPT, latents=mid[None], denoising_start=0.5, **kw).images[0]
    want = np.asarray(jref(PROMPT, latents=jmid[None], denoising_start=0.5,
                           **kw).images[0])
    np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
    scored = refiner(PROMPT, latents=mid[None], denoising_start=0.5, aesthetic_score=3.0,
                     **kw).images[0]
    assert np.isfinite(out).all() and np.abs(scored - out).max() > 0


def test_handoff_refusals(devices8):
    _, port = _sdxl_pair(devices8, "ddim")
    pipe = port()
    kw = dict(num_inference_steps=4, output_type="latent")
    with pytest.raises(ValueError, match="mid-trajectory"):
        pipe(PROMPT, denoising_start=0.5, **kw)
    with pytest.raises(ValueError, match="mid-trajectory"):
        pipe(PROMPT, denoising_start=0.5, latents=_noise(),
             image=np.zeros((32, 32, 3), np.float32), **kw)
    with pytest.raises(ValueError, match="rounds to zero steps"):
        pipe(PROMPT, denoising_end=0.1, **kw)
    with pytest.raises(ValueError, match=r"denoising_end must be in \(0, 1\)"):
        pipe(PROMPT, denoising_end=1.0, **kw)
    with pytest.raises(ValueError, match="start_step 4 outside"):
        pipe(PROMPT, denoising_start=0.99, latents=_noise(), **kw)
    runner = pipe.runner
    enc, added = pipe._encode([PROMPT], [""])
    with pytest.raises(ValueError, match="end_step 2 outside"):
        runner.generate(_noise(), enc, added_cond=added, num_inference_steps=4,
                        start_step=2, end_step=2)
    with pytest.raises(ValueError, match="end_step 5 outside"):
        runner.generate(_noise(), enc, added_cond=added, num_inference_steps=4,
                        end_step=5)


@pytest.mark.parametrize("fields, start, end, want", [
    ({"mode": "corrected_async_gn", "warmup_steps": 1}, 1, 4, ["sync", "sync", "stale"]),
    ({"mode": "corrected_async_gn", "warmup_steps": 1}, 2, 3, ["sync"]),
    ({"mode": "corrected_async_gn", "warmup_steps": 0}, 0, 4,
     ["sync", "stale", "stale", "stale"]),
    ({"mode": "full_sync", "warmup_steps": 0}, 1, 4, ["sync"] * 3),
    ({"parallelism": "naive_patch", "split_scheme": "alternate"}, 1, 4, ["col", "row", "col"]),
])
def test_phases_count_from_the_first_step_run(monkeypatch, fields, start, end, want):
    from distrifuser_tpu_torch import DistriConfig
    from distrifuser_tpu_torch.models import unet
    from distrifuser_tpu_torch.schedulers import get_scheduler

    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (2, 0))
    monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: ("batch", None, None))
    cfg = DistriConfig(device="cpu", height=128, width=128, split_batch=False, **fields)
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    runner = runner_mod.make_runner(cfg, ucfg, unet.init_unet_params(
        torch.Generator().manual_seed(0), ucfg), get_scheduler("ddim"))
    assert runner._phases(end, start) == want
