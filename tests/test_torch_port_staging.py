"""PyTorch port: the serve plane's staged path and prompt cache (ROADMAP
item 16b) against the JAX package's.

Each scenario of tests/test_staging.py that needs no compiled model runs
once per package on the weightless staged fakes (serve/testing.py) with
the same `ServeConfig`, requests and fault rules; both runs must pass the
JAX test's own assertions, and their records (outputs, counters, stage
calls, degradations, cache pins) must be equal.  The prompt cache runs its
LRU, concurrency and server cases the same way.  The tiny real pipelines
(SDXL and PixArt-α) run staged: ``encode_stage`` -> ``denoise_stage`` ->
``decode_stage`` equals the port's own ``__call__`` bit for bit and the
JAX package's staged executor within the pipeline tests' tolerance, a
prompt-cache hit equals the miss bit for bit, and a staged server over
``pipeline_executor_factory`` serves every request equal to its solo call.
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest

PACKAGES = ("distrifuser_tpu", "distrifuser_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tiny models (restored after):
    the whole suite runs six workers on the machine's cores, and the
    default of one thread a core oversubscribes them."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class Pkg:
    def __init__(self, name):
        self.serve = importlib.import_module(f"{name}.serve")
        self.testing = importlib.import_module(f"{name}.serve.testing")
        self.resilience = importlib.import_module(f"{name}.serve.resilience")
        self.metrics = importlib.import_module(f"{name}.utils.metrics")


def serve_config(P, **kw):
    kw.setdefault("max_queue_depth", 32)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("batch_window_s", 0.05)
    kw.setdefault("buckets", ((512, 512),))
    kw.setdefault("default_steps", 4)
    kw.setdefault("pipeline_stages", True)
    return P.serve.ServeConfig(**kw)


def wait_until(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def key_for(P, h, w, steps=4):
    return P.serve.ExecKey(model_id="m", scheduler="ddim", height=h, width=w,
                           steps=steps, cfg=True, mesh_plan="dp1.cfg1.sp1")


# -- the scenarios: each asserts the JAX test's claims and returns a record --


def gap_tracker_math(P):
    g = P.metrics.GapTracker()
    assert g.snapshot()["gap_fraction"] == 0.0
    g.begin(0.0)
    g.end(1.0)
    g.begin(3.0)
    g.end(4.0)
    snap = g.snapshot()
    assert snap["intervals"] == 2
    assert snap["busy_s"] == pytest.approx(2.0)
    assert snap["span_s"] == pytest.approx(4.0)
    assert snap["gap_fraction"] == pytest.approx(0.5)
    with pytest.raises(AssertionError):
        g.end(5.0)  # unbalanced
    return snap


def config_validates_max_inflight(P):
    with pytest.raises(ValueError, match="max_inflight_batches"):
        P.serve.ServeConfig(max_inflight_batches=0)
    assert P.serve.ServeConfig(pipeline_stages=True).max_inflight_batches == 2
    assert P.serve.ServeConfig().pipeline_stages is False
    return True


def keys_compose_with_step_cache_and_compress(P):
    factory = P.testing.StagedFakeExecutorFactory(batch_size=4)
    config = serve_config(P, step_cache_interval=2, step_cache_depth=1,
                          comm_compress="int8")
    with P.serve.InferenceServer(factory, config) as server:
        server.submit("p", height=512, width=512).result(timeout=30)
    (key,) = factory.built
    assert key.step_cache_interval == 2 and key.step_cache_depth == 1
    assert key.comm_compress == "int8"
    snap = server.metrics_snapshot()
    assert snap["config"]["pipeline_stages"] is True
    assert snap["step_cache"]["steps_shallow"] > 0
    return key.short(), snap["step_cache"]


def matches_monolithic(P):
    results = {}
    for staged in (False, True):
        factory = P.testing.StagedFakeExecutorFactory(
            batch_size=4, step_time_s=0.002, encode_s=0.002, decode_s=0.002)
        config = serve_config(P, pipeline_stages=staged)
        with P.serve.InferenceServer(factory, config) as server:
            futs = [server.submit(f"p{i}", height=512, width=512, seed=i)
                    for i in range(6)]
            results[staged] = [f.result(timeout=30) for f in futs]
    for a, b in zip(results[False], results[True]):
        np.testing.assert_array_equal(a.output, b.output)
    expected = P.testing.fake_image("p0", 0, P.serve.ExecKey(
        model_id="model", scheduler="ddim", height=512, width=512,
        steps=4, cfg=True, mesh_plan="dp1.cfg1.sp1"))
    np.testing.assert_array_equal(results[True][0].output, expected)
    return [np.asarray(r.output).tobytes() for r in results[True]]


def metrics_schema_and_gap(P):
    factory = P.testing.StagedFakeExecutorFactory(
        batch_size=1, step_time_s=0.005, encode_s=0.005, decode_s=0.005)
    config = serve_config(P, max_batch_size=1, batch_window_s=0.0)
    with P.serve.InferenceServer(factory, config) as server:
        futs = [server.submit(f"p{i}", height=512, width=512) for i in range(6)]
        for f in futs:
            f.result(timeout=30)
        snap = server.metrics_snapshot()
    staging = snap["staging"]
    assert staging["max_inflight_batches"] == 2
    assert staging["completed"] == staging["submitted"] == len(futs)
    for s in ("encode", "denoise", "decode"):
        assert staging["stages"][s]["service"]["count"] == len(futs)
        assert staging["stages"][s]["queue_wait"]["count"] == len(futs)
    gap = staging["denoise_gap"]
    assert gap["intervals"] == len(futs)
    assert 0.0 <= gap["gap_fraction"] <= 1.0
    json.dumps(snap)  # JSON-serializable end to end
    return (sorted(snap), sorted(staging), sorted(staging["stages"]["denoise"]),
            sorted(gap), staging["completed"], snap["requests"])


def max_inflight_bound(P):
    factory = P.testing.StagedFakeExecutorFactory(batch_size=1, encode_s=0.02,
                                                  denoise_s=0.02, decode_s=0.02)
    config = serve_config(P, max_batch_size=1, batch_window_s=0.0,
                          max_inflight_batches=2)
    with P.serve.InferenceServer(factory, config) as server:
        futs = [server.submit(f"p{i}", height=512, width=512) for i in range(10)]
        for f in futs:
            f.result(timeout=30)
    snap = server.metrics_snapshot()["staging"]
    assert factory.tracker.peak <= 2
    assert snap["peak_inflight"] == 2
    assert factory.tracker.current == 0
    return snap["peak_inflight"], factory.tracker.peak


def throughput_beats_monolithic(P):
    wall = {}
    for staged in (False, True):
        factory = P.testing.StagedFakeExecutorFactory(
            batch_size=1, encode_s=0.02, denoise_s=0.03, decode_s=0.02)
        config = serve_config(P, max_batch_size=1, batch_window_s=0.0,
                              pipeline_stages=staged)
        with P.serve.InferenceServer(factory, config) as server:
            t0 = time.monotonic()
            futs = [server.submit(f"p{i}", height=512, width=512) for i in range(12)]
            for f in futs:
                f.result(timeout=30)
            wall[staged] = time.monotonic() - t0
    assert wall[True] < wall[False] * 0.75, wall
    return True


def stage_failure_is_one_terminal_failure(P):
    factory = P.testing.StagedFakeExecutorFactory(batch_size=4, fail_stage="denoise",
                                                  fail_times=1)
    config = serve_config(P, resilience=P.serve.ResilienceConfig(
        breaker_failure_threshold=1, breaker_cooldown_s=60.0))
    with P.serve.InferenceServer(factory, config) as server:
        bad = server.submit("p", height=512, width=512)
        with pytest.raises(P.serve.ExecuteFailedError, match="staged denoise"):
            bad.result(timeout=30)
        shed = server.submit("p2", height=512, width=512)
        with pytest.raises(P.serve.CircuitOpenError):
            shed.result(timeout=30)
    snap = server.metrics_snapshot()
    assert snap["requests"]["failed_execute"] == 1
    assert snap["requests"]["shed_circuit_open"] == 1
    return snap["requests"], snap["resilience"]["open_circuits"]


def oom_forces_staging_off(P):
    factory = P.testing.StagedFakeExecutorFactory(
        batch_size=4, fail_stage="denoise", fail_times=1,
        fail_exc=RuntimeError("RESOURCE_EXHAUSTED: injected staged OOM"))
    with P.serve.InferenceServer(factory, serve_config(P)) as server:
        bad = server.submit("p", height=512, width=512)
        with pytest.raises(Exception, match="RESOURCE_EXHAUSTED"):
            bad.result(timeout=30)
        ok = server.submit("p2", height=512, width=512).result(timeout=30)
        assert ok.output is not None
        assert "staging_off" in ok.degradations
        health = server.health()
    (ex,) = factory.executors
    assert ex.stage_calls["denoise"] == 1
    assert ex.batch_sizes == [1]
    assert server.counters.get("degraded_staging_off") == 1
    assert any("staging_off" in d["rungs"] for d in health["degradations"].values())
    return (dict(ex.stage_calls), ex.batch_sizes, tuple(ok.degradations),
            health["status"], np.asarray(ok.output).tobytes())


def watchdog_defers_unpin(P):
    factory = P.testing.StagedFakeExecutorFactory(batch_size=4, denoise_s=1.0)
    config = serve_config(P, resilience=P.serve.ResilienceConfig(
        watchdog_timeout_s=0.15, breaker_failure_threshold=100))
    with P.serve.InferenceServer(factory, config) as server:
        fut = server.submit("p", height=512, width=512)
        with pytest.raises(P.serve.WatchdogTimeoutError):
            fut.result(timeout=30)
        (ex,) = factory.executors
        assert server.cache.pin_count(ex) == 1
        assert wait_until(lambda: server.cache.pin_count(ex) == 0, timeout=10)
    return server.metrics_snapshot()["requests"].get("watchdog_timeouts")


def respects_execute_fault_plan(P):
    plan = P.serve.FaultPlan([P.serve.FaultRule(site="execute", kind="execute_error",
                                                at_calls=(0,))])
    factory = P.testing.StagedFakeExecutorFactory(batch_size=4)
    with P.serve.InferenceServer(factory, serve_config(P), fault_plan=plan) as server:
        bad = server.submit("p", height=512, width=512)
        with pytest.raises(P.serve.ExecuteFailedError):
            bad.result(timeout=30)
        ok = server.submit("p2", height=512, width=512).result(timeout=30)
    assert ok.output is not None
    assert plan.fired() == {"execute/execute_error": 1}
    return plan.fired()


def tracker_balances_on_failure(P):
    factory = P.testing.StagedFakeExecutorFactory(batch_size=4, fail_stage="denoise",
                                                  fail_times=1)
    with P.serve.InferenceServer(factory, serve_config(P)) as server:
        with pytest.raises(P.serve.ExecuteFailedError):
            server.submit("p", height=512, width=512).result(timeout=30)
        server.submit("p2", height=512, width=512).result(timeout=30)
    assert factory.tracker.current == 0
    return factory.tracker.peak


def staging_off_rung_requires_staged_server(P):
    R = P.resilience
    key = key_for(P, 512, 512)
    st = R.KeyResilience(breaker=R.CircuitBreaker(3, 1.0))
    mono = R.DegradationLadder(P.serve.ResilienceConfig(), staging=False)
    staged = R.DegradationLadder(P.serve.ResilienceConfig(), staging=True)
    assert mono.next_rung(st, "compile", key, 1) != R.RUNG_STAGING_OFF
    assert staged.next_rung(st, "compile", key, 1) == R.RUNG_STAGING_OFF
    assert staged.apply(key, [R.RUNG_STAGING_OFF]) == key
    off = R.DegradationLadder(P.serve.ResilienceConfig(allow_staging_off=False),
                              staging=True)
    assert off.next_rung(st, "compile", key, 1) != R.RUNG_STAGING_OFF
    return (mono.next_rung(st, "compile", key, 1), off.next_rung(st, "compile", key, 1))


def cancel_mid_stage(P):
    factory = P.testing.StagedFakeExecutorFactory(batch_size=4, encode_s=0.3)
    with P.serve.InferenceServer(factory, serve_config(P, batch_window_s=0.0)) as server:
        fut = server.submit("doomed", height=512, width=512)
        assert wait_until(lambda: len(factory.executors) == 1
                          and factory.executors[0].stage_calls["encode"] == 1)
        assert fut.cancel()
        assert wait_until(lambda: server.counters.get("staged_cancelled") == 1)
        ok = server.submit("live", height=512, width=512).result(timeout=30)
    assert ok.output is not None
    assert factory.executors[0].stage_calls["denoise"] == 1
    return dict(factory.executors[0].stage_calls)


def deadline_before_denoise(P):
    factory = P.testing.StagedFakeExecutorFactory(batch_size=4, encode_s=0.5)
    with P.serve.InferenceServer(factory, serve_config(P, batch_window_s=0.0)) as server:
        fut = server.submit("late", height=512, width=512, ttl_s=0.2)
        with pytest.raises(P.serve.DeadlineExceededError, match="before the denoise"):
            fut.result(timeout=30)
    assert factory.executors[0].stage_calls["denoise"] == 0
    assert server.counters.get("staged_expired") == 1
    assert server.counters.get("rejected_deadline") == 1
    return dict(factory.executors[0].stage_calls)


def stop_drains_deterministically(P):
    factory = P.testing.StagedFakeExecutorFactory(batch_size=1, denoise_s=0.2)
    config = serve_config(P, max_batch_size=1, batch_window_s=0.0, max_inflight_batches=2)
    server = P.serve.InferenceServer(factory, config).start(warmup=False)
    futs = [server.submit(f"p{i}", height=512, width=512) for i in range(6)]
    assert wait_until(lambda: any(f.done() for f in futs), timeout=20)
    server.stop(timeout=10.0)
    assert all(f.done() for f in futs), "stop() left futures unresolved"
    outcomes = {"ok": 0, "closed": 0}
    for f in futs:
        try:
            assert f.result(timeout=0).output is not None
            outcomes["ok"] += 1
        except P.serve.ServerClosedError:
            outcomes["closed"] += 1
    assert outcomes["ok"] >= 1 and outcomes["closed"] >= 1, outcomes
    assert server.metrics_snapshot()["staging"]["inflight"] == 0
    return True


def plain_executor_falls_back(P):
    factory = P.testing.FakeExecutorFactory(batch_size=4)
    with P.serve.InferenceServer(factory, serve_config(P)) as server:
        r = server.submit("p", height=512, width=512).result(timeout=30)
    assert r.output is not None
    snap = server.metrics_snapshot()
    assert snap["staging"]["submitted"] == 0
    assert snap["requests"]["completed"] == 1
    return np.asarray(r.output).tobytes(), snap["requests"]


def cache_pin_skips_lru_eviction(P):
    evicted = []
    cache = P.serve.ExecutorCache(lambda k: object(), capacity=1,
                                  on_evict=lambda k, e: evicted.append(k))
    k1, k2, k3 = key_for(P, 512, 512), key_for(P, 768, 768), key_for(P, 1024, 1024)
    ex1, _ = cache.get(k1, pin=True)
    cache.get(k2)
    assert k1 in cache and k2 in cache
    assert evicted == []
    assert cache.stats()["pinned"] == 1
    cache.unpin(ex1)
    assert cache.pin_count(ex1) == 0
    cache.get(k3)
    assert k1 not in cache and k1 in evicted
    assert cache.stats()["deferred_evictions"] == 0
    return [k.short() for k in evicted], sorted(cache.stats())


def cache_pin_refcounts_and_invalidate(P):
    evicted = []
    cache = P.serve.ExecutorCache(lambda k: object(), capacity=4,
                                  on_evict=lambda k, e: evicted.append((k, e)))
    k = key_for(P, 512, 512)
    ex, _ = cache.get(k, pin=True)
    ex_again, hit = cache.get(k, pin=True)
    assert hit and ex_again is ex and cache.pin_count(ex) == 2
    assert cache.invalidate(k)
    assert k not in cache and evicted == []
    cache.unpin(ex)
    assert evicted == []
    cache.unpin(ex)
    assert evicted == [(k, ex)]
    ex2, hit2 = cache.get(k)
    assert not hit2 and ex2 is not ex
    return cache.stats()["deferred_evictions"]


def cache_unpinned_behavior_unchanged(P):
    evicted = []
    cache = P.serve.ExecutorCache(lambda k: f"exec-{k.height}", capacity=2,
                                  on_evict=lambda k, e: evicted.append(k))
    k1, k2, k3 = key_for(P, 512, 512), key_for(P, 768, 768), key_for(P, 1024, 1024)
    cache.get(k1), cache.get(k2), cache.get(k3)
    assert evicted == [k1]
    assert cache.stats()["deferred_evictions"] == 0
    assert cache.stats()["pinned"] == 0
    return [k.short() for k in evicted]


def prompt_cache_lru_and_counters(P):
    cache = P.serve.PromptCache(2)
    calls = []

    def enc(tag):
        def f():
            calls.append(tag)
            return {"emb": tag}
        return f

    assert cache.get_or_encode("a", enc("a")) == {"emb": "a"}
    assert cache.get_or_encode("a", enc("a2")) == {"emb": "a"}
    assert calls == ["a"]
    cache.get_or_encode("b", enc("b"))
    cache.get_or_encode("c", enc("c"))
    assert cache.get_or_encode("a", enc("a3")) == {"emb": "a3"}
    snap = cache.snapshot()
    assert snap["entries"] == 2 and snap["capacity"] == 2
    assert snap["hits"] == 1 and snap["misses"] == 4
    assert cache.hit_rate() == pytest.approx(0.2)
    return snap, calls


def prompt_cache_concurrent(P):
    cache = P.serve.PromptCache(8)
    n = [0]
    lock = threading.Lock()

    def enc():
        with lock:
            n[0] += 1
        return "v"

    threads = [threading.Thread(target=lambda: [cache.get_or_encode("k", enc)
                                                for _ in range(50)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cache.get_or_encode("k", enc) == "v"
    assert len(cache) == 1 and n[0] >= 1
    return len(cache)


def server_prompt_cache_hits(P):
    config = P.serve.ServeConfig(buckets=((512, 512),), max_batch_size=2,
                                 batch_window_s=0.0, pipeline_stages=True,
                                 prompt_cache_capacity=8)
    factory = P.testing.StagedFakeExecutorFactory(batch_size=2, encode_s=0.0)
    server = P.serve.InferenceServer(factory, config, model_id="m")
    with server:
        a = server.submit("same prompt", height=512, width=512, seed=1).result(timeout=30)
        b = server.submit("same prompt", height=512, width=512, seed=1).result(timeout=30)
        snap = server.metrics_snapshot()
    assert snap["prompt_cache"]["hits"] >= 1 and snap["prompt_cache"]["misses"] >= 1
    np.testing.assert_array_equal(a.output, b.output)
    counter = server.registry.counter("serve_prompt_cache").snapshot()
    assert counter.get("hits", 0) >= 1
    return snap["prompt_cache"], counter, np.asarray(a.output).tobytes()


SCENARIOS = {f.__name__: f for f in (
    gap_tracker_math, config_validates_max_inflight,
    keys_compose_with_step_cache_and_compress, matches_monolithic,
    metrics_schema_and_gap, max_inflight_bound, throughput_beats_monolithic,
    stage_failure_is_one_terminal_failure, oom_forces_staging_off,
    watchdog_defers_unpin, respects_execute_fault_plan, tracker_balances_on_failure,
    staging_off_rung_requires_staged_server, cancel_mid_stage, deadline_before_denoise,
    stop_drains_deterministically, plain_executor_falls_back,
    cache_pin_skips_lru_eviction, cache_pin_refcounts_and_invalidate,
    cache_unpinned_behavior_unchanged, prompt_cache_lru_and_counters,
    prompt_cache_concurrent, server_prompt_cache_hits)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_staged_scenario_matches_jax(name):
    want = SCENARIOS[name](Pkg(PACKAGES[0]))
    got = SCENARIOS[name](Pkg(PACKAGES[1]))
    assert got == want


# -- the tiny real pipelines, staged -----------------------------------------


import torch  # noqa: E402

from test_torch_port_serve_pipeline import (  # noqa: E402
    SDXL_TOL, _jax_sdxl, _port_sdxl, sdxl_trees)  # noqa: F401 -- fixture
from test_torch_port_pixart import (  # noqa: E402
    _close, _jax_pipe as _jax_pixart, _port_pipe as _port_pixart, dit, t5, trees)  # noqa: F401

STEPS = 2


def _staged(ex, prompts, seeds, gs=5.0):
    work = ex.encode_stage(prompts, [""] * len(prompts), seeds)
    work = ex.denoise_stage(work, gs)
    return ex.decode_stage(work)


@pytest.mark.parametrize("family", ["sdxl", "pixart"])
def test_real_staged_executor_equals_call_and_jax(devices8, family, sdxl_trees, trees):  # noqa: F811
    from distrifuser_tpu.serve.executors import PipelineExecutor as JaxExecutor
    from distrifuser_tpu_torch.serve import PipelineExecutor, PromptCache

    if family == "sdxl":
        port, jpipe = _port_sdxl(sdxl_trees), _jax_sdxl(devices8, sdxl_trees)
    else:
        port = _port_pixart(trees, "dpm-solver")
        jpipe = _jax_pixart(devices8, trees, "dpm-solver", use_cuda_graph=False)
    prompts, seeds = ["a lighthouse at dusk", "a corgi", "a fox"], [3, 4, 5]
    ex = PipelineExecutor(port, STEPS)
    staged = _staged(ex, prompts, seeds)
    mono = ex(prompts, [""] * 3, 5.0, seeds)
    assert len(staged) == 3
    for a, b in zip(staged, mono):
        np.testing.assert_array_equal(a, b)
    # the same stages against the JAX staged executor, on the same latents
    lat = np.random.RandomState(0).randn(4, 16, 16, 4).astype(np.float32)
    jex = JaxExecutor(jpipe, STEPS)
    jex._draw_latents = lambda s: lat[:len(s)]
    ex._draw_latents = lambda s: torch.from_numpy(lat[:len(s)])
    for pipe_ex in (ex, jex):
        pipe_ex.pipeline.scheduler.set_timesteps(STEPS)
    jwork = jex.denoise_stage(jex.encode_stage(prompts[:2], ["", ""], seeds[:2]), 5.0)
    pwork = ex.denoise_stage(ex.encode_stage(prompts[:2], ["", ""], seeds[:2]), 5.0)
    want, got = np.asarray(jwork["latent"]), pwork["latent"].numpy()
    if family == "sdxl":
        np.testing.assert_allclose(got, want, rtol=0, atol=SDXL_TOL)
    else:
        _close(got, want)
    # a prompt-cache hit serves the miss's image bit for bit, the cached
    # embeddings untouched by the denoise that consumed them
    cache = PromptCache(4)
    ex.attach_prompt_cache(cache)
    first = ex(prompts[:2], ["", ""], 5.0, seeds[:2])
    (key,) = list(cache._entries)
    cached = [t.clone() for t in cache._entries[key] if isinstance(t, torch.Tensor)]
    again = ex(prompts[:2], ["", ""], 5.0, seeds[:2])
    assert cache.snapshot()["hits"] == 1 and cache.snapshot()["misses"] == 1
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(cached, [t for t in cache._entries[key] if isinstance(t, torch.Tensor)]):
        assert torch.equal(a, b)


def test_real_staged_server_serves_solo_images(sdxl_trees):  # noqa: F811
    from distrifuser_tpu_torch.serve import (InferenceServer, ServeConfig,
                                             pipeline_executor_factory)

    pipe = _port_sdxl(sdxl_trees)
    config = ServeConfig(buckets=((128, 128),), max_batch_size=2, batch_window_s=0.2,
                         default_steps=STEPS, warmup_buckets=((128, 128),),
                         pipeline_stages=True, max_inflight_batches=2,
                         prompt_cache_capacity=8)
    reqs = [("a lighthouse at dusk", 11), ("a corgi", 12), ("a lighthouse at dusk", 11),
            ("a fox", 13)]
    with InferenceServer(pipeline_executor_factory(lambda key: pipe), config,
                         model_id="tiny-sdxl") as server:
        futs = [server.submit(p, height=128, width=128, seed=s) for p, s in reqs]
        results = [f.result(timeout=120) for f in futs]
        snap = server.metrics_snapshot()
    assert snap["staging"]["completed"] == snap["staging"]["submitted"] >= 2
    for (prompt, seed), r in zip(reqs, results):
        solo = pipe(prompt, seed=seed, num_inference_steps=STEPS, output_type="np").images[0]
        np.testing.assert_array_equal(r.output, solo)
