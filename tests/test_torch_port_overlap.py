"""PyTorch port: which collectives of a patch-path step can overlap compute
(parallel/overlap.py), held against the JAX package's classification of
its compiled program (distrifuser_tpu/utils/overlap.py
``analyze_loop_collectives``, the check of tests/test_overlap.py).

The tiny SD UNet at sp 2 (``split_batch=False``), warmup 1, 4 DDIM steps:
two synchronous then two stale evaluations.  The port runs on 2 gloo ranks
(tests/test_torch_port_ranks.py ``overlap_worker``) with every collective
recorded; the JAX runner's loop is compiled for 2 fake CPU devices and its
two loop bodies classified (the warm-up body synchronous, the scan stale).

* gather, ring and the int8-compressed refresh: in the stale evaluation
  every layer's refresh is deferred (issued inside the forward, waited in
  ``finish``), as every refresh collective of the JAX stale body is
  deferred (through the dequantize's elementwise ops for the compressed
  one); what is inline matches in kind and count: the output gather, and
  under the ring its hops.  The synchronous evaluation is the negative
  control: every exchange inline, as in the JAX warm-up body.
* ``comm_batch``: the port issues the step's flat refreshes in ``flush``,
  after the forward, and waits for them in ``finish`` with no compute
  between ("flushed"), where the JAX package carries the flush's value to
  the next iteration (deferred): the difference ROADMAP queue 3 logs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.parallel.runner import DenoiseRunner as JaxDenoiseRunner
from distrifuser_tpu.schedulers import get_scheduler
from distrifuser_tpu.utils.overlap import analyze_loop_collectives
from test_torch_port_ranks import jax_layout, overlap_worker, run_ranks

CONFIGS = {"gather": {}, "ring": {"attn_impl": "ring"}, "int8": {"comm_compress": "int8"},
           "comm_batch": {"comm_batch": True}}
PERMUTES = {"halo": 2, "ring_shift": 1}  # JAX collective-permutes per port exchange


@pytest.fixture(scope="module")
def inputs():
    from distrifuser_tpu_torch.models import unet

    ucfg = unet.tiny_config(cross_attention_dim=32)
    params = unet.init_unet_params(torch.Generator().manual_seed(0), ucfg)
    rs = np.random.RandomState(9)
    return params, rs.randn(1, 16, 16, 4).astype(np.float32), \
        rs.randn(2, 1, 7, 32).astype(np.float32)


@pytest.fixture(scope="module")
def runs(inputs, devices8, tmp_path_factory):
    """(port, jax): {config: [(phase, collectives), ...] of each evaluation}
    on rank 0 (rank 1 recorded the same), and {config: (synchronous body,
    stale body)} of the JAX loop's report; the ranks run while the JAX
    package compiles."""
    params, latents, enc = inputs
    tmp = tmp_path_factory.mktemp("overlap")
    cases = [{"split_batch": False, **fields} for fields in CONFIGS.values()]
    torch.save({"cases": cases, "params": params, "latents": torch.from_numpy(latents),
                "enc": torch.from_numpy(enc)}, tmp / "in.pt")
    wait = run_ranks(2, overlap_worker, tmp, str(tmp / "in.pt"), str(tmp / "out"),
                     join=False)
    ucfg = jax_unet.tiny_config(cross_attention_dim=32)
    jax_out = {}
    for name, fields in CONFIGS.items():
        cfg = JaxDistriConfig(devices=devices8[:2], height=128, width=128, warmup_steps=1,
                              split_batch=False, **fields)
        runner = JaxDenoiseRunner(cfg, ucfg, jax_layout(params), get_scheduler("ddim"))
        hlo = runner._build(4).lower(runner.params, jnp.asarray(latents), jnp.asarray(enc),
                                     None, 5.0).compile().as_text()
        reports = {ew: analyze_loop_collectives(hlo, elementwise_carry=ew)
                   for ew in (False, True)}
        assert len(reports[False]) == 2, [r.body for r in reports[False]]
        stale = max(range(2), key=lambda i: reports[False][i].n_deferred)
        # strict (pure data movement to the carry), and the stale body with
        # the dequantize's elementwise ops allowed on the way
        jax_out[name] = (reports[False][1 - stale], reports[False][stale],
                         reports[True][stale])
    wait()
    ranks = [torch.load(f"{tmp / 'out'}.rank{r}") for r in range(2)]
    assert ranks[0] == ranks[1]
    port = {name: ranks[0][tuple(sorted(case.items()))] for name, case in zip(CONFIGS, cases)}
    return port, jax_out


def _jax_counts(body, bucket):
    """{opcode: count} of a JAX body's ``bucket``: "inline", "deferred", or
    "deferred_compute" (the elementwise-carry ones)."""
    items = getattr(body, bucket).values()
    out = {}
    for op in items:
        op = "all-gather" if op.startswith("all-gather") else op
        out[op] = out.get(op, 0) + 1
    return out


def _port_counts(collectives, verdicts):
    """The port's collectives of these verdicts as JAX opcodes: an all-gather
    each, a halo pair two collective-permutes, a ring hop one."""
    out = {}
    for c in collectives:
        if c["verdict"] not in verdicts:
            continue
        op = "all-gather" if c["op"] == "all_gather" else "collective-permute"
        out[op] = out.get(op, 0) + PERMUTES.get(c["op"], 1)
    return out


def _evaluation(port, name, phase):
    """The collectives of the first evaluation of ``phase``."""
    evaluations = port[name]
    assert [p for p, _ in evaluations] == ["sync", "sync", "stale", "stale"]
    return evaluations[2 if phase == "stale" else 0][1]


@pytest.mark.parametrize("name", ["gather", "ring", "int8"])
def test_stale_refreshes_deferred_as_in_jax(runs, name):
    port, jax_out = runs
    stale = _evaluation(port, name, "stale")
    refreshes = [c for c in stale if c["names"]]
    assert refreshes and all(c["verdict"] == "deferred" for c in refreshes), refreshes
    assert {k for c in refreshes for k in c["kinds"]} == (
        {"conv2d", "gn"} if name == "ring" else {"conv2d", "gn", "attn"})
    others = [c for c in stale if not c["names"]]
    assert all(c["verdict"] == "inline" for c in others)
    _, jstale, jstale_ew = jax_out[name]
    if name != "int8":
        # inline: the output gather, and the ring's hops; every refresh
        # reaches only the carry
        assert _port_counts(stale, {"inline"}) == _jax_counts(jstale, "inline")
        assert _port_counts(stale, {"deferred"}) == _jax_counts(jstale, "deferred")
        return
    # int8: the exact GroupNorm moments reach the carry as they are; each
    # coded KV refresh (payload and scales, two JAX all-gathers) and halo
    # pair (four permutes) through the dequantize, with the output gather
    # then deferred too: nothing of the JAX stale body stays inline
    assert not jstale_ew.inline
    exact = [c for c in refreshes if c["kinds"] == ["gn"]]
    assert _port_counts(exact, {"deferred"}) == _jax_counts(jstale, "deferred")
    coded = {kind: sum(c["kinds"] == [kind] for c in refreshes) for kind in ("attn", "conv2d")}
    assert _jax_counts(jstale_ew, "deferred_compute") == {
        "all-gather": 2 * coded["attn"] + 1, "collective-permute": 4 * coded["conv2d"]}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sync_exchanges_inline_as_in_jax(runs, name):
    """Negative control: the synchronous evaluation's KV gathers (and every
    other exchange) are waited before the layer computes with them."""
    port, jax_out = runs
    sync = _evaluation(port, name, "sync")
    assert sync and all(c["verdict"] == "inline" for c in sync)
    kv = [c for c in sync if c["kinds"] == ["attn"]]
    assert (not kv) if name == "ring" else kv
    jsync = jax_out[name][0]
    assert jsync.n_deferred == 0 and jsync.n_inline
    assert _port_counts(sync, {"inline"}) == _jax_counts(jsync, "inline")


def test_comm_batch_flush_waits_with_nothing_between(runs):
    """The batched flush: issued after the forward, waited in ``finish``
    ("flushed": it overlaps no compute of its step); the JAX package's
    flush reaches only the loop carry (deferred)."""
    port, jax_out = runs
    stale = _evaluation(port, "comm_batch", "stale")
    refreshes = [c for c in stale if c["names"]]
    assert refreshes and all(c["issued"] == "flush" and c["waited"] == "finish"
                             and c["verdict"] == "flushed" for c in refreshes)
    assert {k for c in refreshes for k in c["kinds"]} == {"conv2d", "gn", "attn"}
    _, jstale, _ = jax_out["comm_batch"]
    assert _port_counts(stale, {"flushed"}) == _jax_counts(jstale, "deferred")
    assert _port_counts(stale, {"inline"}) == _jax_counts(jstale, "inline")
