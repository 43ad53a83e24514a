"""PyTorch port: the sequence-parallel VAE and the pipeline's decoder choice.

The tiny VAE's seeded weights (the port's init, carried to the JAX layout
by ``jax_layout``; back by ``params_from_jax``) and the same numpy latents and images go through the
port's ``decode_sp`` / ``encode_sp`` on n gloo ranks
(tests/test_torch_port_ranks.py ``vae_sp_worker``) and through the JAX
package's on an ``sp`` mesh of n fake CPU devices, at n = 2 and 4, float32:
the gathered decode and the encode's mean agree with the JAX package's
at the same n and with the whole decode / encode within 2e-4
(tests/test_vae_sp.py pins 2e-4).  A sample of ``encode_sp`` is finite, the
same on every rank, and not the whole encode's draw.  The tiny SD
pipeline's decode at those worlds (sp n, CFG 2 x sp 2, dp 2 x sp 2, and
``vae_sp=False``) decodes as the JAX package's ``_build_decoder`` picks
and gives the whole decode's images; ``decoder_choice`` equals
``_build_decoder``'s choice over a grid of layouts and sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.parallel.collectives import gather_rows
from distrifuser_tpu.pipelines import _build_decoder
from distrifuser_tpu.utils.compat import shard_map
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.pipelines import decoder_choice
from distrifuser_tpu_torch.utils import config as config_mod
from test_torch_port_ranks import jax_layout, run_ranks, vae_sp_worker

TOL = 2e-4
WORLDS = (2, 4)
# the pipeline's decode at each world: config fields
PIPE_CASES = {
    2: [{"split_batch": False}, {"split_batch": False, "vae_sp": False}],
    4: [{"split_batch": False}, {},
        {"split_batch": False, "dp_degree": 2, "batch_size": 2}],
}


@pytest.fixture(scope="module")
def vae_inputs():
    from distrifuser_tpu_torch.models import vae

    cfg = jax_vae.tiny_vae_config()
    params = jax_layout(vae.init_vae_params(torch.Generator().manual_seed(0),
                                            vae.tiny_vae_config()))
    rs = np.random.RandomState(1)
    lat = rs.randn(2, 16, 12, 4).astype(np.float32)
    img = rs.uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    return cfg, params, lat, img


@pytest.fixture(scope="module")
def port(vae_inputs, tmp_path_factory):
    """{n: every rank's saved results} of ``vae_sp_worker`` at n ranks."""
    _, params, lat, img = vae_inputs
    tmp = tmp_path_factory.mktemp("vae_sp")
    out = {}
    for n in WORLDS:
        torch.save({"vae": params_from_jax(params), "lat": torch.from_numpy(lat),
                    "img": torch.from_numpy(img), "cases": PIPE_CASES[n]},
                   tmp / f"in{n}.pt")
        run_ranks(n, vae_sp_worker, tmp, str(tmp / f"in{n}.pt"), str(tmp / f"out{n}"))
        out[n] = [torch.load(f"{tmp / f'out{n}'}.rank{r}") for r in range(n)]
    return out


def _sp(devices, n, fn):
    mesh = Mesh(np.array(devices[:n]), axis_names=("sp",))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(), P(None, "sp")), out_specs=P(),
                             check_vma=False))


@pytest.fixture(scope="module")
def jax_ref(vae_inputs, devices8):
    cfg, params, lat, img = vae_inputs
    ref = {"decode": np.asarray(jax_vae.decode(params, cfg, jnp.asarray(lat))),
           "encode": np.asarray(jax_vae.encode(params, cfg, jnp.asarray(img)))}
    for n in WORLDS:
        ref[("decode", n)] = np.asarray(_sp(devices8, n, lambda p, x: gather_rows(
            jax_vae.decode_sp(p, cfg, x, n, axis="sp")))(params, lat))
        ref[("encode", n)] = np.asarray(_sp(devices8, n, lambda p, x: jax.lax.all_gather(
            jax_vae.encode_sp(p, cfg, x, n, axis="sp"), "sp", axis=1, tiled=True))(
                params, img))
    return ref


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("what", ["decode", "encode"])
def test_sp_matches_jax_and_whole(port, jax_ref, n, what):
    """Every rank's gathered decode (encode: the posterior mean) equals the
    JAX package's at the same n and the whole decode (encode)."""
    for rank in port[n]:
        got = rank[what].numpy()
        assert got.shape == jax_ref[what].shape
        np.testing.assert_allclose(got, jax_ref[(what, n)], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, jax_ref[what], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_encode_sp_sample_is_a_per_rank_draw(port, vae_inputs, n):
    """With a generator each rank adds its own draw: the gathered sample is
    finite, the same on every rank, off the mean, and not the whole
    encode's draw from the same seed."""
    from distrifuser_tpu_torch.models import vae

    _, params, _, img = vae_inputs
    samples = [rank["sample"] for rank in port[n]]
    assert all(torch.equal(s, samples[0]) for s in samples)
    sample, mean = samples[0], port[n][0]["encode"]
    assert sample.shape == mean.shape and torch.isfinite(sample).all()
    assert (sample - mean).abs().min() > 0
    whole = vae.encode(params_from_jax(params), vae.tiny_vae_config(),
                       torch.from_numpy(img), generator=torch.Generator().manual_seed(7))
    assert (sample - whole).abs().max() > 1e-3


@pytest.mark.parametrize("n, case", [(n, c) for n in WORLDS for c in PIPE_CASES[n]],
                         ids=lambda v: str(v))
def test_pipeline_decode_follows_jax(port, vae_inputs, jax_ref, devices8, n, case):
    """The tiny SD pipeline at n ranks picks the JAX package's decoder and
    decodes both latents to the whole decode's images on every rank
    (sequence-parallel over the patch group, the image groups' shares
    gathered under dp)."""
    cfg, params, lat, _ = vae_inputs
    jcfg = JaxDistriConfig(devices=devices8[:n], height=8 * lat.shape[1],
                           width=8 * lat.shape[2], **case)
    want_parallel = _build_decoder(jcfg, cfg)[1]
    want = np.clip(np.asarray(jax_vae.decode(params, cfg, jnp.asarray(lat)
                                             / cfg.scaling_factor)) / 2 + 0.5, 0, 1)
    for rank in port[n]:
        parallel, tile, images = rank[tuple(sorted(case.items()))]
        assert (parallel, tile) == (want_parallel, 0)
        assert images.shape == want.shape
        np.testing.assert_allclose(images.numpy(), want, rtol=TOL, atol=TOL)
    assert want_parallel == case.get("vae_sp", True)


@pytest.mark.parametrize("world, fields, height", [
    (1, {}, 1024), (1, {}, 2048),
    (4, {}, 1024), (4, {"split_batch": False}, 2048),
    (4, {"parallelism": "naive_patch"}, 1024),
    (4, {"vae_sp": False}, 2048), (4, {"vae_sp": False}, 1024),
    (8, {"split_batch": False}, 96),  # 12 latent rows do not split 8 ways
    (2, {"split_batch": False, "parallelism": "tensor"}, 2048),
    (4, {"dp_degree": 2, "batch_size": 2, "split_batch": False}, 1024),
    (4, {"dp_degree": 2, "batch_size": 2}, 2048),  # CFG 2 x sp 1 a group
    (8, {"dp_degree": 2, "batch_size": 2}, 2048),
], ids=str)
def test_decoder_choice_equals_build_decoder(devices8, monkeypatch, world, fields, height):
    """(sequence-parallel?, tile) as the JAX package's ``_build_decoder``
    picks them; its tile read from the decode its jitted function calls."""
    vcfg = jax_vae.tiny_vae_config()
    jcfg = JaxDistriConfig(devices=devices8[:world], height=height, width=64, **fields)
    fn, parallel = _build_decoder(jcfg, vcfg)
    tiles = []
    if not parallel:
        monkeypatch.setattr(jax_vae, "decode",
                            lambda p, c, x, tile=0: tiles.append(tile) or x)
        fn({}, jnp.zeros((1, height // 8, 8, 4)))
    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (world, 0))
    monkeypatch.setattr(config_mod, "_process_groups",
                        lambda w, n, r, dp: (None, None, None))
    cfg = config_mod.DistriConfig(device="cpu", height=height, width=64, **fields)
    assert decoder_choice(cfg) == (parallel, 0 if parallel else tiles[0])
