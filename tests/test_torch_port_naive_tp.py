"""PyTorch port: naive patch and tensor parallelism against the JAX package.

Tiny SDXL, 128 x 128, 4 DDIM steps, float32, on 2 and 4 gloo ranks (one
spawn per world size, every case inside it; workers in
tests/test_torch_port_ranks.py) against the JAX runner (``make_runner``) on
a fake CPU mesh of the same devices:

* naive patch parallelism in the ``row``, ``col`` and ``alternate``
  schemes, at sp 2 and sp 4 (no CFG split): the unmodified UNet on each
  rank's slice, gathered after every step;
* tensor parallelism at tp 2 (world 2), at CFG 2 x tp 2 and at tp 4
  (world 4).

The latents agree with the JAX package's within 5e-4 of their largest
magnitude and are the same on every rank.  Tensor parallelism is exact
math, so it also agrees with the port's dense runner on one process within
the same bound.  The port's ``prepare_tp_params`` shards equal the JAX
package's shards (its padded tree sliced by its sharding spec); with a
head count that n does not divide (5 and 2 heads at n = 4; the tiny UNet's
4 heads divide), the padded heads are zero and the ranks' partial
attention outputs sum to the dense one.
"""

import jax
import numpy as np
import pytest
import torch

from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.models import unet_tp as jax_tp
from distrifuser_tpu.utils.config import SP_AXIS
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models import unet_tp as port_tp
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.ops.attention import attention
from distrifuser_tpu_torch.parallel.runner import DenoiseRunner
from distrifuser_tpu_torch.schedulers import get_scheduler
from distrifuser_tpu_torch.utils.config import DistriConfig
from test_torch_port_patch_runner import REL, run_both, runner_inputs

SCHEMES = ("row", "col", "alternate")
NAIVE = [{"parallelism": "naive_patch", "split_scheme": s, "split_batch": False}
         for s in SCHEMES]
TP = {2: [{"parallelism": "tensor", "split_batch": False}],
      4: [{"parallelism": "tensor", "split_batch": True},
          {"parallelism": "tensor", "split_batch": False}]}


def _key(case):
    return tuple(sorted(case.items()))


@pytest.fixture(scope="module")
def results(devices8, tmp_path_factory):
    """{world: run_both results} of every case at world 2 and 4."""
    return {w: run_both(devices8, tmp_path_factory.mktemp(f"naive_tp{w}"), w,
                        NAIVE + TP[w]) for w in (2, 4)}


@pytest.fixture(scope="module")
def dense_latent():
    """The port's dense runner on one process on the same inputs."""
    ucfg, params, latents, enc, added = runner_inputs()
    cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1)
    runner = DenoiseRunner(cfg, ucfg, params_from_jax(jax.device_get(params)),
                           get_scheduler("ddim"))
    return runner.generate(latents, enc, added_cond={k: torch.from_numpy(v)
                                                     for k, v in added.items()},
                           num_inference_steps=4, guidance_scale=5.0).numpy()


def _check(result):
    port_x, comm, phases, want, _ = result
    assert np.isfinite(want).all()
    for x in port_x:
        np.testing.assert_array_equal(x, port_x[0])
    err = np.abs(port_x[0] - want).max() / np.abs(want).max()
    assert err <= REL, err
    assert comm == {} and phases == {"sync": 4, "stale": 0}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_naive_patch_matches_jax(results, world, scheme):
    case = {"parallelism": "naive_patch", "split_scheme": scheme, "split_batch": False}
    _check(results[world][_key(case)])


@pytest.mark.parametrize("world,split_batch", [(2, False), (4, True), (4, False)],
                         ids=["tp2", "cfg2_tp2", "tp4"])
def test_tensor_parallel_matches_jax_and_dense(results, dense_latent, world, split_batch):
    result = results[world][_key({"parallelism": "tensor", "split_batch": split_batch})]
    _check(result)
    err = np.abs(result[0][0] - dense_latent).max() / np.abs(dense_latent).max()
    assert err <= REL, err


def _jax_shard(tp_tree, spec_tree, n, idx):
    """Rank ``idx``'s shard of the JAX package's padded TP tree, in the
    port's layout: each leaf sliced along its sharded axis, the stacked
    [in, 2, out] projections and [2, out] biases flattened to the port's
    fused [k | v] and [value | gate] forms, conv kernels OIHW."""

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(t, s)]
        t = np.asarray(t)
        axes = [i for i, name in enumerate(tuple(s)) if name == SP_AXIS]
        if axes:
            t = np.split(t, n, axis=axes[0])[idx]
        if t.ndim == 3:  # [in, 2, out] -> [in, 2 * out]
            t = t.reshape(t.shape[0], -1)
        elif t.ndim == 2 and t.shape[0] == 2 and tuple(s) == (None, SP_AXIS):
            t = t.reshape(-1)  # [2, inner] GEGLU bias
        return t

    return params_from_jax(walk(tp_tree, spec_tree))


@pytest.mark.parametrize("n", [2, 4])
def test_prepare_tp_params_equals_jax_shards(n):
    ucfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = jax.device_get(jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg))
    tp_tree, specs = jax_tp.prepare_tp_params(params, ucfg, n)
    dense = params_from_jax(params)
    for idx in range(n):
        want = _flat(_jax_shard(jax.device_get(tp_tree), specs, n, idx))
        got = _flat(port_tp.prepare_tp_params(dense, ucfg, n, idx))
        assert want.keys() == got.keys()
        for path, w in want.items():
            assert got[path].shape == w.shape and torch.equal(got[path], w), path
    assert port_tp.head_dim_table(port_unet.tiny_config(
        cross_attention_dim=32, sdxl=True)) == jax_tp.head_dim_table(ucfg)


@pytest.mark.parametrize("heads", [5, 2])
def test_padded_heads_are_zero_and_add_nothing(heads):
    """``_shard_attn`` at n = 4 with a head count that 4 does not divide:
    the shards equal the JAX package's, a padded head's q, k, v columns
    and output rows are zero, and the partial outputs of the four ranks
    sum to the dense attention (the all-reduce, done by hand)."""
    n, d = 4, 16
    c = heads * d
    rs = np.random.RandomState(heads)
    jp = {"to_q": {"kernel": rs.randn(c, c).astype(np.float32) * 0.3},
          "to_kv": {"kernel": rs.randn(c, 2 * c).astype(np.float32) * 0.3},
          "to_out": {"kernel": rs.randn(c, c).astype(np.float32) * 0.3,
                     "bias": rs.randn(c).astype(np.float32) * 0.1}}
    jtp, jspec = jax_tp._shard_attn(jp, heads, n)
    p = params_from_jax(jp)
    x = torch.from_numpy(rs.randn(2, 10, c).astype(np.float32))
    total = 0
    for idx in range(n):
        shard = port_tp._shard_attn(p, heads, n, idx)
        want = _flat(_jax_shard(jax.device_get(jtp), jspec, n, idx))
        for path, w in _flat(shard).items():
            assert torch.equal(w, want[path]), path
        local = shard["to_q"]["kernel"].shape[1] // d  # heads a rank, padding included
        real = min(max(heads - idx * local, 0), local)  # of which real
        q_pad = shard["to_q"]["kernel"][:, real * d:]
        out_pad = shard["to_out"]["kernel"][real * d:]
        kv = shard["to_kv"]["kernel"].reshape(c, 2, local * d)[:, :, real * d:]
        assert not q_pad.any() and not out_pad.any() and not kv.any()
        q = x @ shard["to_q"]["kernel"]
        k, v = (x @ shard["to_kv"]["kernel"]).chunk(2, dim=-1)
        total = total + port_tp.sdpa(q, k, v, heads=local) @ shard["to_out"]["kernel"]
    torch.testing.assert_close(total + p["to_out"]["bias"], attention(p, x, heads=heads),
                               rtol=0, atol=1e-5)


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    return {path: leaf for k, sub in items for path, leaf in _flat(sub, f"{prefix}.{k}").items()}
