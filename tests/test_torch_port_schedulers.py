"""PyTorch port: Euler and DPM-Solver++ 2M against the JAX package.

For ``epsilon`` and ``v_prediction`` at 4, 13 and 50 steps, the port's and
the JAX package's scheduler get the same numpy latents and model outputs
at every step: timesteps, ``init_noise_sigma`` and the sigma tables are
equal, and ``scale_model_input`` and ``step`` (DPM++'s carried x0 and
lambda and its first-order first and last steps included) agree within
rtol 1e-4, atol 1e-5 of the running latent, the per-op tolerance (float32
sum-order differences of the second-order correction only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distrifuser_tpu.schedulers import get_scheduler as jax_get_scheduler
from distrifuser_tpu_torch.pipelines import _check_scheduler_family
from distrifuser_tpu_torch.schedulers import get_scheduler

RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("steps", [4, 13, 50])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("name", ["euler", "dpm-solver", "ddim"])
def test_scheduler_matches_jax(name, prediction_type, steps):
    js = jax_get_scheduler(name, prediction_type=prediction_type).set_timesteps(steps)
    ps = get_scheduler(name, prediction_type=prediction_type).set_timesteps(steps)
    np.testing.assert_array_equal(ps.timesteps().numpy(), np.asarray(js.timesteps()))
    assert ps.init_noise_sigma == js.init_noise_sigma
    if name == "euler":
        np.testing.assert_array_equal(ps._sigmas.numpy(), np.asarray(js._sigmas))
    r = np.random.RandomState(steps)
    x = (r.randn(2, 8, 8, 4) * js.init_noise_sigma).astype(np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    jstate, pstate = js.init_state(x.shape), ps.init_state(x.shape)
    for i in range(steps):
        jin, pin = js.scale_model_input(jx, i), ps.scale_model_input(px, i)
        np.testing.assert_allclose(pin.numpy(), np.asarray(jin), rtol=RTOL, atol=ATOL)
        out = r.randn(*x.shape).astype(np.float32)
        jx, jstate = js.step(jx, jnp.asarray(out), i, jstate)
        px, pstate = ps.step(px, torch.from_numpy(out), i, pstate)
        want = np.asarray(jx)
        assert px.dtype == torch.float32 and np.isfinite(want).all()
        np.testing.assert_allclose(px.numpy(), want, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(want).max()))
    if name == "dpm-solver":  # the carried x0 after the last step
        np.testing.assert_allclose(pstate["x0_prev"].numpy(), np.asarray(jstate["x0_prev"]),
                                   rtol=RTOL, atol=ATOL * max(1.0, np.abs(want).max()))


def test_dpm_solver_last_step_returns_x0():
    """At the last step sigma reaches 0: the update is x0 itself."""
    s = get_scheduler("dpm-solver").set_timesteps(4)
    x, eps = torch.randn(1, 4, 4, 4), torch.randn(1, 4, 4, 4)
    state = s.init_state(x.shape)
    for i in range(3):
        x, state = s.step(x, eps, i, state)
    a, sg = s._alpha[3], s._sigma[3]
    out, _ = s.step(x, eps, 3, state)
    torch.testing.assert_close(out, (x - sg * eps) / a, rtol=1e-6, atol=1e-6)


def test_flow_euler_is_the_flow_sampler_and_unknown_names_are_refused():
    """"flow-euler" is the SD3 family's sampler (tests/test_torch_port_sd3.py
    holds it to the JAX one); an unknown name is refused with the list of
    names."""
    assert get_scheduler("flow-euler").prediction_type == "flow"
    with pytest.raises(ValueError, match="must be one of"):
        get_scheduler("pndm")


def test_flow_euler_is_refused_naming_its_item():
    """"flow-euler" is refused off the SD3 family, by every epsilon/v
    family, naming the pipeline it is for."""
    for family in ("DistriSDXLPipeline", "DistriSDPipeline", "DistriPixArtPipeline"):
        with pytest.raises(ValueError,
                           match=f"'flow-euler' on {family}.*DistriSD3Pipeline"):
            _check_scheduler_family(get_scheduler("flow-euler"), family)


def test_flow_scheduler_refused_on_sd_family():
    """A rectified-flow sampler (prediction_type "flow", as the JAX
    package's FlowMatchEulerScheduler pins it) is refused by the UNet
    families, as the JAX package's _check_scheduler_family refuses it."""
    class Flow:
        prediction_type = "flow"

    with pytest.raises(ValueError, match="rectified-flow"):
        _check_scheduler_family(Flow(), "DistriSDPipeline")
    _check_scheduler_family(get_scheduler("euler"), "DistriSDPipeline")
