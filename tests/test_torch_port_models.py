"""PyTorch port: CLIP, VAE decode, DDIM and the CFG fold against the JAX
package, float32 on the CPU.

The scheduler is also held to closed-form goldens (the point-mass exactness
and independent-reference checks of the JAX scheduler tests, restated here
for the port's DDIM).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu.models import clip as jax_clip
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.parallel import guidance as jax_guidance
from distrifuser_tpu.schedulers import get_scheduler as jax_get_scheduler
from distrifuser_tpu.utils.config import DistriConfig as JaxDistriConfig
from distrifuser_tpu_torch.models import clip as port_clip
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.parallel import guidance as port_guidance
from distrifuser_tpu_torch.schedulers import get_scheduler
from distrifuser_tpu_torch.schedulers.scheduling import (
    _leading_timesteps,
    _make_alphas_cumprod,
)
from distrifuser_tpu_torch.utils.config import DistriConfig

# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_forward_matches_jax(act):
    cfg = jax_clip.CLIPTextConfig(vocab_size=1000, hidden_size=32,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  intermediate_size=64, hidden_act=act,
                                  projection_dim=24)
    jparams = jax_clip.init_clip_params(jax.random.PRNGKey(0), cfg)
    # ids in and out of the tiny vocab (the hash tokenizer's BOS/EOS)
    ids = np.full((2, 77), 49407, np.int64)
    ids[:, 0] = 49406
    ids[0, 1:4] = [5, 17, 998]
    ids[1, 1:6] = [7, 7, 300, 12, 1]
    want = jax_clip.clip_text_forward(jparams, cfg, ids)
    pcfg = port_clip.CLIPTextConfig(**{f: getattr(cfg, f) for f in
                                       cfg.__dataclass_fields__})
    got = port_clip.clip_text_forward(params_from_jax(jax.device_get(jparams)),
                                      pcfg, torch.from_numpy(ids))
    assert len(got["hidden_states"]) == len(want["hidden_states"]) == 3
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    for key in ("last_hidden_state", "pooler_output", "text_embeds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-5)


def test_full_width_text_configs_match_jax():
    assert (vars(port_clip.clip_vit_l_config())
            == vars(jax_clip.clip_vit_l_config()))
    assert (vars(port_clip.open_clip_bigg_config())
            == vars(jax_clip.open_clip_bigg_config()))
    assert vars(port_vae.sdxl_vae_config()) == vars(jax_vae.sdxl_vae_config())

# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def test_vae_decode_matches_jax():
    cfg = jax_vae.tiny_vae_config()
    jparams = jax_vae.init_vae_params(jax.random.PRNGKey(1), cfg)
    lat = np.random.RandomState(0).randn(1, 16, 16, 4).astype(np.float32)
    want = jax_vae.decode(jparams, cfg, jnp.asarray(lat))
    got = port_vae.decode(params_from_jax(jax.device_get(jparams)),
                          port_vae.tiny_vae_config(), torch.from_numpy(lat))
    assert tuple(got.shape) == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

# ---------------------------------------------------------------------------
# DDIM: per step against JAX, then closed-form goldens
# ---------------------------------------------------------------------------

SHAPE = (2, 4, 4, 3)


def _rand(seed):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_ddim_steps_match_jax(pred):
    steps = 7
    js = jax_get_scheduler("ddim", prediction_type=pred).set_timesteps(steps)
    ps = get_scheduler("ddim", prediction_type=pred).set_timesteps(steps)
    np.testing.assert_array_equal(ps.timesteps().numpy(), np.asarray(js.timesteps()))
    x = _rand(0)
    for i in range(steps):
        out = np.tanh(x) + 0.1 * i
        want, _ = js.step(jnp.asarray(x), jnp.asarray(out), i, {})
        got, _ = ps.step(torch.from_numpy(x), torch.from_numpy(out), i, {})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        x = np.array(want)


def test_leading_timesteps_golden():
    ts = _leading_timesteps(1000, 50, 1)
    assert ts[0] == 981 and ts[1] == 961 and ts[-1] == 1
    assert len(ts) == 50 and np.all(np.diff(ts) == -20)
    ac = _make_alphas_cumprod(1000, 0.00085, 0.012, "scaled_linear")
    assert ac[0] == pytest.approx(1 - 0.00085, rel=1e-12)
    assert len(ac) == 1000 and ac[-1] < 5e-3 and np.all(np.diff(ac) < 0)


@pytest.mark.parametrize("steps", [7, 50])
@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_ddim_point_mass_exact(steps, pred):
    """A point mass at x0: the exact epsilon maps alpha_t x0 + sigma_t n to
    alpha_prev x0 + sigma_prev n at every step (DDIM eq. 12, eta = 0)."""
    ac = _make_alphas_cumprod(1000, 0.00085, 0.012, "scaled_linear")
    ts = _leading_timesteps(1000, steps, 1)
    a, s = np.sqrt(ac[ts]), np.sqrt(1 - ac[ts])
    prev = ts - 1000 // steps
    ac_prev = np.where(prev >= 0, ac[np.clip(prev, 0, None)], ac[0])
    a_p, s_p = np.sqrt(ac_prev), np.sqrt(1 - ac_prev)
    x0, n = _rand(0).astype(np.float64), _rand(1).astype(np.float64)
    sched = get_scheduler("ddim", prediction_type=pred).set_timesteps(steps)
    x = torch.from_numpy((a[0] * x0 + s[0] * n).astype(np.float32))
    for i in range(steps):
        out = n if pred == "epsilon" else a[i] * n - s[i] * x0
        x, _ = sched.step(x, torch.from_numpy(out.astype(np.float32)), i, {})
        np.testing.assert_allclose(x.numpy(), a_p[i] * x0 + s_p[i] * n,
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("steps", [4, 13, 50])
def test_ddim_matches_independent_reference(steps):
    """float64 numpy DDIM driven by a nonlinear fake model."""
    def fake_eps(x, i):
        return np.tanh(0.7 * np.asarray(x, np.float64)) + 0.05 * np.cos(float(i))

    ac = _make_alphas_cumprod(1000, 0.00085, 0.012, "scaled_linear")
    ts = _leading_timesteps(1000, steps, 1)
    ratio = 1000 // steps
    x_ref = _rand(6).astype(np.float64)
    sched = get_scheduler("ddim").set_timesteps(steps)
    x = torch.from_numpy(x_ref.astype(np.float32))
    for i, t in enumerate(ts):
        eps = fake_eps(x_ref, i)
        a_t, a_p = ac[t], (ac[t - ratio] if t - ratio >= 0 else ac[0])
        x0 = (x_ref - np.sqrt(1 - a_t) * eps) / np.sqrt(a_t)
        x_ref = np.sqrt(a_p) * x0 + np.sqrt(1 - a_p) * eps
        out = torch.from_numpy(fake_eps(x.numpy(), i).astype(np.float32))
        x, _ = sched.step(x, out, i, {})
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=5e-4, atol=5e-5,
                                   err_msg=f"step {i}/{steps}")

# ---------------------------------------------------------------------------
# classifier-free guidance fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_on", [True, False])
def test_guidance_fold_matches_jax(devices8, cfg_on):
    jcfg = JaxDistriConfig(devices=devices8[:1], do_classifier_free_guidance=cfg_on)
    pcfg = DistriConfig(device="cpu", do_classifier_free_guidance=cfg_on)
    r = np.random.RandomState(0)
    n_br = 2 if cfg_on else 1
    enc = r.randn(n_br, 3, 5, 8).astype(np.float32)
    added = {"text_embeds": r.randn(n_br, 3, 4).astype(np.float32),
             "time_ids": r.randn(n_br, 3, 6).astype(np.float32)}
    je, ja, jm = jax_guidance.branch_select(
        jcfg, jnp.asarray(enc), jax.tree.map(jnp.asarray, added))
    pe, pa, pm = port_guidance.branch_select(
        pcfg, torch.from_numpy(enc), {k: torch.from_numpy(v) for k, v in added.items()})
    assert pm == jm
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    for k in added:
        np.testing.assert_array_equal(pa[k].numpy(), np.asarray(ja[k]))
    out = r.randn(n_br * 3, 4, 4, 4).astype(np.float32)
    want = jax_guidance.combine_guidance(jcfg, jnp.asarray(out),
                                         jnp.asarray(7.5, jnp.float32), 3)
    got = port_guidance.combine_guidance(pcfg, torch.from_numpy(out),
                                         torch.tensor(7.5), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
