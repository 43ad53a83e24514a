"""PyTorch port: the static-buffer UNet step (``use_cuda_graph``) and its
configuration.

On the CPU ``use_cuda_graph=True`` runs the step the card captures, from
static input buffers, with the stale phase reading a static buffer set that
each replay's refreshes are copied into (parallel/graphs.py), but without a
capture.  It must equal the eager step (``use_cuda_graph=False``) bit for
bit: dense on one process, and the displaced patch path at world 2 in
``full_sync`` and ``corrected_async_gn``, which is also held against the
JAX package at the same n (latents within 5e-4 of their largest
magnitude).  Then the config fields the JAX package has (``use_cuda_graph``
and its ``use_compiled_step`` alias, ``split_scheme``, ``comm_checkpoint``,
``verbose``), the refusal of graphs where ranks share a card over gloo,
the pipeline's ``prepare`` and ``set_stepwise``, and the step callback.
The ``cuda``-marked test captures the flash and quantized-matmul wrappers
in a graph on the card; it skips here.  This file imports jax only inside
the tests that compare with the JAX package, so that the card tests run
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_graphs.py -q
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
from distrifuser_tpu_torch.models import clip, unet, vae
from distrifuser_tpu_torch.parallel import runner as runner_mod
from distrifuser_tpu_torch.parallel.runner import DenoiseRunner
from distrifuser_tpu_torch.schedulers import get_scheduler
from distrifuser_tpu_torch.utils import config as config_mod

PATCH_MODES = ("full_sync", "corrected_async_gn")


def _tiny_inputs(seed=3):
    """(UNet config, port params, latents, embeddings, added cond), float32."""
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = unet.init_unet_params(torch.Generator().manual_seed(0), ucfg)
    rs = np.random.RandomState(seed)
    latents = torch.from_numpy(rs.randn(1, 16, 16, 4).astype(np.float32))
    enc = torch.from_numpy(rs.randn(2, 1, 7, 32).astype(np.float32))
    added = {"text_embeds": torch.from_numpy(rs.randn(2, 1, 32).astype(np.float32)),
             "time_ids": torch.tensor([128.0, 128, 0, 0, 128, 128]).expand(2, 1, 6)}
    return ucfg, params, latents, enc, added


def _run(use_cuda_graph, steps=4, **fields):
    ucfg, params, latents, enc, added = _tiny_inputs()
    cfg = DistriConfig(device="cpu", height=128, width=128,
                       use_cuda_graph=use_cuda_graph, **fields)
    runner = DenoiseRunner(cfg, ucfg, params, get_scheduler("ddim"))
    seen = []
    x = runner.generate(latents, enc, added_cond=added, num_inference_steps=steps,
                        callback=lambda i, t, x: seen.append((i, int(t), x.clone())))
    return x, seen, runner


def test_dense_static_step_equals_eager_bit_for_bit():
    eager, seen_e, _ = _run(False)
    graphed, seen_g, runner = _run(True)
    assert torch.equal(eager, graphed)
    assert [s[:2] for s in seen_e] == [s[:2] for s in seen_g] == [
        (i, int(t)) for i, t in enumerate(runner.scheduler.timesteps())]
    for (_, _, xe), (_, _, xg) in zip(seen_e, seen_g):
        assert torch.equal(xe, xg)
    assert list(runner.graphs.graphs) == ["sync"]
    assert runner.graphs.key == (1, 16, 16, 4)


@pytest.fixture(scope="module")
def patch_world2(devices8, tmp_path_factory):
    from test_torch_port_patch_runner import run_both

    cases = [{"mode": m, "split_batch": False, "use_cuda_graph": g}
             for m in PATCH_MODES for g in (False, True)]
    return run_both(devices8, tmp_path_factory.mktemp("graphs2"), 2, cases)


@pytest.mark.parametrize("mode", PATCH_MODES)
def test_patch_static_step_equals_eager_and_jax(patch_world2, mode):
    from test_torch_port_patch_runner import check_case

    key = lambda g: (("mode", mode), ("split_batch", False),  # noqa: E731
                     ("use_cuda_graph", g))
    eager, graphed = patch_world2[key(False)], patch_world2[key(True)]
    for x_e, x_g in zip(eager[0], graphed[0]):
        np.testing.assert_array_equal(x_e, x_g)
    assert eager[1:3] == graphed[1:3]  # comm volume, steps by phase
    check_case(graphed, mode)


def test_config_fields_match_the_jax_package():
    from distrifuser_tpu.utils import config as jax_config

    jax_defaults = {f.name: f.default for f in dataclasses.fields(jax_config.DistriConfig)}
    cfg = DistriConfig(device="cpu")
    for name in ("use_cuda_graph", "split_scheme", "comm_checkpoint", "verbose"):
        assert getattr(cfg, name) == jax_defaults[name], name
    assert config_mod.SPLIT_SCHEMES == jax_config.SPLIT_SCHEMES
    assert cfg.use_compiled_step is True
    cfg = DistriConfig(device="cpu", use_cuda_graph=False, comm_checkpoint=7,
                       verbose=True, split_scheme="alternate")
    assert cfg.use_compiled_step is False and cfg.comm_checkpoint == 7
    with pytest.raises(ValueError, match="split_scheme"):
        DistriConfig(device="cpu", split_scheme="bogus")
    with pytest.raises(ValueError, match="comm_checkpoint"):
        DistriConfig(device="cpu", comm_checkpoint=0)


@pytest.mark.parametrize("backend,refused", [("gloo", True), ("nccl", False)])
def test_graphs_refused_where_ranks_share_a_card(monkeypatch, backend, refused):
    """Two ranks on a CUDA device: a gloo group stages every payload through
    the host, so ``use_cuda_graph=True`` is refused when the runner is
    built; under NCCL, or with ``use_cuda_graph=False``, it builds."""
    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (2, 0))
    monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: ("batch", None, None))
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: backend)
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    for use_cuda_graph in (True, False):
        cfg = DistriConfig(device="cpu", height=128, width=128, split_batch=False,
                           use_cuda_graph=use_cuda_graph)
        cfg.device = torch.device("cuda", 0)  # as a rank on a card sees it
        if refused and use_cuda_graph:
            with pytest.raises(ValueError, match="gloo.*use_cuda_graph=False"):
                runner_mod.DenoiseRunner(cfg, ucfg, {}, get_scheduler("ddim"))
        else:
            runner_mod.DenoiseRunner(cfg, ucfg, {}, get_scheduler("ddim"))


def test_verbose_prints_the_stale_buffer_report(monkeypatch, capsys):
    """``verbose`` prints ``comm_volume_report``'s element counts by layer
    kind in the JAX package's words; without it nothing is printed."""
    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (2, 0))
    monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: ("batch", None, None))
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    for verbose in (False, True):
        cfg = DistriConfig(device="cpu", height=128, width=128, split_batch=False,
                           verbose=verbose)
        runner = DenoiseRunner(cfg, ucfg, {}, get_scheduler("ddim"))
        runner._buffer_numel = {"a": 2_500_000, "b": 1_000_000, "c": 500_000}
        runner._buffer_kinds = {"a": "attn", "b": "conv2d", "c": "attn"}
        assert runner.comm_volume_report() == {"attn": 3_000_000, "conv2d": 1_000_000}
        printed = capsys.readouterr().out.splitlines()
        assert printed == ([] if not verbose else [
            "Stale-state buffers: 4.000M elements over 3 tensors per device.",
            "  attn: 3.000M elements", "  conv2d: 1.000M elements"])


def test_failed_capture_leaves_no_graph(monkeypatch):
    """On a CUDA device a capture that raises leaves no graph registered,
    so the next generation captures again (and raises again) rather than
    finding its phases and running them eagerly; a graph that was never
    captured refuses to replay on the card."""
    from distrifuser_tpu_torch.parallel import graphs as graphs_mod

    calls = []

    def failing_capture(self, graphs, phases, missing, step_fn):
        calls.append(list(missing))
        raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs_mod.StepGraphs, "_capture", failing_capture)
    graphs = graphs_mod.StepGraphs(torch.device("cuda", 0))
    x, t = torch.zeros(2, 4, 4, 4), torch.tensor(999)
    enc = torch.zeros(2, 7, 32)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            graphs.begin((1, 4, 4, 4), x, t, enc, None, {}, ["sync", "stale"],
                         ["stale"], lambda phase, inputs, state: None)
        assert graphs.graphs == {} and graphs.key is None
    assert calls == [["sync", "stale"], ["sync", "stale"]]
    graph = graphs_mod.StepGraph("sync", graphs_mod.StepInputs(x, t, enc, None, {}),
                                 stateful=False, device=torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="never captured"):
        graph.replay(lambda phase, inputs, state: (inputs.x_in, None))


def test_every_kernel_wrapper_counts_its_launches():
    """The wrappers that launch a kernel of ``csrc/`` are the ones listed
    in ``LAUNCH_COUNTERS``, the list the graphs replay counts into."""
    from distrifuser_tpu_torch.ops import _build, flash_attention, quant_matmul, quantize

    assert set(_build.LAUNCH_COUNTERS) == {flash_attention.flash_sdpa,
                                           quant_matmul.quant_matmul,
                                           quantize.quantize_rows,
                                           quantize.quantize_rows_grouped,
                                           quantize.dequantize_rows_grouped}
    assert all(fn.launches >= 0 for fn in _build.LAUNCH_COUNTERS)


def _tiny_pipeline(**fields):
    gen = torch.Generator().manual_seed(0)
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    vcfg = vae.tiny_vae_config()
    tcfgs = [clip.tiny_clip_config(hidden=16),
             clip.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=32,
                                 projection_dim=32)]
    cfg = DistriConfig(device="cpu", height=128, width=128, **fields)
    return DistriSDXLPipeline.from_params(
        cfg, ucfg, unet.init_unet_params(gen, ucfg), vcfg,
        vae.init_vae_params(torch.Generator().manual_seed(1), vcfg), tcfgs,
        [clip.init_clip_params(gen, tc) for tc in tcfgs])


def test_pipeline_prepare_and_set_stepwise():
    """``prepare`` readies the graphs of the call's shape before it;
    ``set_stepwise`` switches between the eager loop and the static-buffer
    step, with the same latents and the same callback steps; a call at
    another batch re-captures; new weights drop the graphs."""
    pipe = _tiny_pipeline()
    latents = np.random.RandomState(4).randn(1, 16, 16, 4).astype(np.float32)
    pipe.prepare(3)
    graphs = pipe.runner.graphs
    assert graphs.key == (1, 16, 16, 4) and list(graphs.graphs) == ["sync"]
    outs, seen = {}, {}
    for stepwise in (True, False, True):
        pipe.set_stepwise(stepwise)
        assert pipe.distri_config.use_cuda_graph is not stepwise
        steps = seen[stepwise] = []
        outs[stepwise] = pipe("a red boat", latents=latents, num_inference_steps=3,
                              output_type="latent",
                              callback=lambda i, t, x: steps.append((i, int(t)))).images[0]
    np.testing.assert_array_equal(outs[True], outs[False])
    assert seen[True] == seen[False] == [(0, 667), (1, 334), (2, 1)]
    pipe.set_stepwise(False)
    two = pipe(["a red boat", "a blue car"], num_inference_steps=1, output_type="latent")
    assert len(two.images) == 2 and graphs.key == (1, 16, 16, 4)  # batch_size 1 chunks
    pipe.distri_config.batch_size = 2
    pipe(["a red boat", "a blue car"], num_inference_steps=1, output_type="latent")
    assert graphs.key == (2, 16, 16, 4)
    pipe.set_weight_quant("int8")
    assert graphs.key is None and not graphs.graphs


def test_dropping_the_runner_frees_its_graphs():
    """A graph holds no reference back to its runner, so dropping the
    runner frees the graphs at once, without a garbage-collector pass: a
    graph holding NCCL work must be gone before its process group is
    destroyed."""
    _, _, runner = _run(True, steps=1)
    graph = weakref.ref(runner.graphs["sync"])
    gc.disable()
    try:
        del runner
        assert graph() is None
    finally:
        gc.enable()


def test_set_stepwise_refuses_graphs_where_ranks_share_a_card(monkeypatch):
    pipe = _tiny_pipeline(use_cuda_graph=False)
    cfg = pipe.distri_config
    monkeypatch.setattr(cfg, "world_size", 2)
    monkeypatch.setattr(cfg, "device", torch.device("cuda", 0))
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "gloo")
    with pytest.raises(ValueError, match="share a card"):
        pipe.set_stepwise(False)
    assert cfg.use_cuda_graph is False


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_wrappers_replay_in_a_graph_on_card(mode):
    """The flash and quantized-linear wrappers captured in one graph: the
    warm-up and the capture count no launch, each replay counts the three
    it holds, and a replay on new inputs equals the eager call bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distrifuser_tpu_torch.ops.flash_attention import flash_sdpa
    from distrifuser_tpu_torch.ops.linear import linear
    from distrifuser_tpu_torch.parallel.compress import quantize_weight
    from distrifuser_tpu_torch.ops._build import LAUNCH_COUNTERS
    from distrifuser_tpu_torch.parallel.graphs import StepGraph, StepInputs, copy_tree

    g = torch.Generator(device="cuda").manual_seed(0)

    def operands():
        q = torch.randn(2, 1024, 640, device="cuda", generator=g).bfloat16()
        kv = torch.randn(2, 1024, 1280, device="cuda", generator=g).bfloat16()
        x = torch.randn(2, 1024, 640, device="cuda", generator=g).bfloat16()
        return x, {"q": q, "kv": kv}

    w = (torch.randn(640, 1280, device="cuda", generator=g) / 25).bfloat16()
    layer = {"kernel": quantize_weight(w, mode).with_compute("pallas"),
             "bias": torch.randn(1280, device="cuda", generator=g).bfloat16()}

    def step(phase, inp, state):
        k, v = inp.enc["kv"].chunk(2, dim=-1)
        return flash_sdpa(inp.enc["q"], k, v, heads=10), {"y": linear(layer, inp.x_in)}

    x, enc = operands()
    inputs = StepInputs(x, torch.zeros((), device="cuda"), enc, None, {})
    graph = StepGraph("sync", inputs, stateful=False, device=torch.device("cuda"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.run(step)  # warm-up: loads the kernels, sets their attributes
    torch.cuda.current_stream().wait_stream(side)
    counts = [fn.launches for fn in LAUNCH_COUNTERS]
    graph.capture(step, torch.cuda.graph_pool_handle(), side)
    assert [fn.launches for fn in LAUNCH_COUNTERS] == counts
    assert {fn.__name__: n for fn, n in graph.launches.items()} == {
        "flash_sdpa": 1, "quant_matmul": 1, "quantize_rows": 1}
    x2, enc2 = operands()
    inputs.set_step(x2, torch.ones((), device="cuda"))
    copy_tree(inputs.enc, enc2)
    out, state = graph.replay(step)
    torch.cuda.synchronize()
    assert [fn.launches for fn in LAUNCH_COUNTERS] == [
        c + graph.launches.get(fn, 0) for fn, c in zip(LAUNCH_COUNTERS, counts)]
    want_out, want_state = graph.run(step)
    assert torch.equal(out, want_out) and torch.equal(state["y"], want_state["y"])
