"""PyTorch port: the closed-loop SLO controller (ROADMAP item 16d) against
the JAX package's.

* Every scenario of tests/test_controller.py runs once per package on the
  weightless fakes (serve/testing.py), with the same configs, injected
  clocks and load: both pass the JAX test's assertions and their records
  (tier walks, transitions, admissions, dispatch counters, snapshots) are
  equal -- the tier table and its validation, ``apply_tier``, the ladder's
  precedence over a tier, the controller's escalation, retraction,
  hysteresis, measured breach, replay determinism, calibration and
  ``tier_for_batch``, the server's escalation to a typed admission
  rejection and its retraction when idle, the controller off, the
  time-aged SLO windows, ``apply_key_policy``'s partial refresh, the
  registry's aging conflict, and the prompt cache.
* ``apply_tier`` on every default tier, for patch and pipefusion keys,
  gives the JAX function's key field for field.
* On the tiny SDXL pipeline, a server whose controller is held at
  ``reduced_steps`` serves its tier key's solo image bit for bit; the
  JAX package's server held there, fed the initial latents of the tier
  pipeline's solo calls, serves images within the pipeline tests' 2e-4 of
  theirs.
"""

import dataclasses
import importlib
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

PACKAGES = ("distrifuser_tpu", "distrifuser_tpu_torch")
_MODULES = ("utils.config", "utils.metrics", "serve.resilience", "serve.controller",
            "serve.testing", "serve")
_PKGS = {}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tiny models (restored after):
    the whole suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def pkg(name):
    """The package's serve names as one flat namespace (``P.SLOController``,
    ``P.FakeExecutorFactory``, ``P.RollingQuantile`` ...)."""
    if name not in _PKGS:
        ns = types.SimpleNamespace(name=name)
        for mod in _MODULES:
            m = importlib.import_module(f"{name}.{mod}")
            for k, v in vars(m).items():
                if not k.startswith("__"):
                    setattr(ns, k, v)
        ns.executors = importlib.import_module(f"{name}.serve.executors")
        _PKGS[name] = ns
    return _PKGS[name]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def key_for(P, **kw):
    kw.setdefault("model_id", "m")
    kw.setdefault("scheduler", "ddim")
    kw.setdefault("height", 512)
    kw.setdefault("width", 512)
    kw.setdefault("steps", 4)
    kw.setdefault("cfg", True)
    kw.setdefault("mesh_plan", "dp1.cfg1.sp1")
    return P.ExecKey(**kw)


def key_fields(k):
    return dataclasses.asdict(k)


# -- the scenarios: each asserts the JAX test's claims and returns a record --


def tier_table_validation(P):
    norm = P.normalize_tier_table
    assert norm(()) == P.DEFAULT_TIERS
    msgs = []
    for bad, match in (([P.TierSpec("a", 0.9)], "cost 1.0"),
                       ([P.TierSpec("a", 1.0), P.TierSpec("b", 1.0)], "strictly decrease"),
                       ([P.TierSpec("a", 1.0), P.TierSpec("a", 0.5)], "unique")):
        with pytest.raises(ValueError, match=match) as info:
            norm(bad)
        msgs.append(str(info.value))
    with pytest.raises(ValueError):
        P.TierSpec("bad", 1.0, refresh_fraction=0.3).validate()
    with pytest.raises(ValueError):
        P.TierSpec("bad", 1.0, step_cache=(2, 0)).validate()
    tiers = norm([{"name": "full", "cost": 1.0},
                  {"name": "cheap", "cost": 0.5, "step_cache": [2, 1]}])
    assert tiers[1].step_cache == (2, 1)
    cfg = P.ControllerConfig(enabled=True, slo_p99_s={"default": 1.0})
    assert cfg.tiers == P.DEFAULT_TIERS
    with pytest.raises(ValueError, match="default") as info:
        P.ControllerConfig(slo_p99_s={"premium": 1.0})
    msgs.append(str(info.value))
    return msgs, [dataclasses.astuple(t) for t in tiers]


def apply_tier_key_mapping(P):
    base = key_for(P)
    assert P.apply_tier(base, P.DEFAULT_TIERS[0]) is base
    k = P.apply_tier(base, P.DEFAULT_TIERS[3])
    assert (k.step_cache_interval, k.step_cache_depth) == (2, 1)
    assert k.comm_compress == "int8" and k.refresh_fraction == 0.5
    assert k.steps == base.steps
    k2 = P.apply_tier(base, P.DEFAULT_TIERS[4])
    assert k2.steps == 2 and k2.refresh_fraction == 0.5
    pf = key_for(P, parallelism="pipefusion", pipe_patches=2)
    k3 = P.apply_tier(pf, P.DEFAULT_TIERS[4])
    assert k3.refresh_fraction == 1.0 and k3.comm_compress == "none"
    assert k3.steps == 2 and k3.parallelism == "pipefusion"
    return [x.short() for x in (k, k2, k3)]


def exec_key_refresh_fraction_validation(P):
    k = key_for(P, refresh_fraction=0.5)
    assert ":pr0.5" in k.short()
    with pytest.raises(ValueError):
        key_for(P, refresh_fraction=0.3)
    with pytest.raises(ValueError, match="patch"):
        key_for(P, parallelism="pipefusion", pipe_patches=2, refresh_fraction=0.5)
    return k.short()


def ladder_rungs_win_over_controller_tier(P):
    clock = FakeClock()
    eng = P.ResilienceEngine(P.ResilienceConfig(), clock=clock)
    tier_key = P.apply_tier(key_for(P), P.DEFAULT_TIERS[1])
    assert tier_key.step_cache_interval == 2
    rung = eng.degrade(tier_key, "oom", 1)
    assert rung == P.RUNG_STEP_CACHE_OFF
    final = eng.degraded_key(tier_key)
    assert (final.step_cache_interval, final.step_cache_depth) == (1, 0)
    assert final.steps == tier_key.steps
    return rung, final.short()


def _controller(P, clock, **cfg_kw):
    cfg_kw.setdefault("enabled", True)
    cfg_kw.setdefault("slo_p99_s", {"default": 0.5})
    cfg_kw.setdefault("escalate_cooldown_s", 1.0)
    cfg_kw.setdefault("retract_cooldown_s", 2.0)
    cfg_kw.setdefault("service_prior_s", 0.1)
    return P.SLOController(P.ControllerConfig(**cfg_kw), clock=clock, batch_hint=4)


def _snap(queue=0, inflight=0, classes=None):
    return {"queue_depth": queue, "inflight_requests": inflight, "classes": classes or {}}


def escalates_under_load_one_rung_per_cooldown(P):
    clock = FakeClock()
    ctl = _controller(P, clock)
    ctl.admit("default")
    heavy = _snap(queue=100)
    walk = []
    ctl.poll(heavy)
    walk.append(ctl._state("default").tier)
    assert walk[-1] == 0
    clock.advance(1.0)
    ctl.poll(heavy)
    walk.append(ctl._state("default").tier)
    assert walk[-1] == 1
    ctl.poll(heavy)
    assert ctl._state("default").tier == 1
    for _ in range(10):
        clock.advance(1.0)
        ctl.poll(heavy)
        walk.append(ctl._state("default").tier)
    assert ctl._state("default").tier == len(ctl.tiers)
    assert not ctl.admit("default")
    return walk, ctl.snapshot()


def retracts_when_load_drops(P):
    clock = FakeClock()
    ctl = _controller(P, clock)
    st = ctl._state("default")
    st.tier = len(ctl.tiers)
    clock.advance(5.0)
    ctl.poll(_snap())
    assert st.tier == len(ctl.tiers) - 1
    walk = [st.tier]
    for _ in range(10):
        clock.advance(5.0)
        ctl.poll(_snap())
        walk.append(st.tier)
    assert st.tier == 0 and ctl.admit("default")
    return walk, ctl.snapshot()


def hysteresis_no_flap_at_boundary(P):
    clock = FakeClock()
    ctl = _controller(P, clock, retract_margin=0.5)
    st = ctl._state("default")
    st.tier = 2
    before = st.transitions
    for _ in range(20):
        clock.advance(3.0)
        ctl.poll(_snap(queue=20))
    assert st.tier == 2 and st.transitions == before
    return st.tier, st.transitions


def measured_breach_escalates_only_under_live_load(P):
    clock = FakeClock()
    ctl = _controller(P, clock, min_samples=2)
    st = ctl._state("default")
    breach = {"default": {"count": 10, "window": 10, "p99": 3.0}}
    clock.advance(2.0)
    ctl.poll(_snap(classes=breach))
    assert st.tier == 0
    clock.advance(2.0)
    ctl.poll(_snap(queue=1, classes=breach))
    assert st.tier == 1
    return ctl.snapshot()


def replayed_load_is_deterministic(P):
    trace = [(0.0, _snap(queue=40)), (1.1, _snap(queue=40)), (2.2, _snap(queue=40)),
             (3.3, _snap(queue=2)), (6.0, _snap()), (9.0, _snap()), (12.0, _snap())]

    def run():
        clock = FakeClock()
        ctl = _controller(P, clock)
        walk = []
        for t, snap in trace:
            clock.t = t
            ctl.poll(snap)
            walk.append(ctl._state("default").tier)
        return walk

    walk = run()
    assert walk == run()
    return walk


def service_calibration_normalizes_by_tier_cost(P):
    ctl = _controller(P, FakeClock())
    assert ctl.service_estimate() == pytest.approx(0.1)
    ctl.observe_batch(0, 0.2)
    ctl.observe_batch(4, 0.06)
    assert ctl.service_estimate() == pytest.approx(0.2)
    ctl.observe_step(0.5, 0.1, requests=4, dispatches=2)
    return round(ctl.service_estimate(), 12), round(ctl.step_service_estimate(), 12)


def tier_for_batch_takes_cheapest_needed(P):
    ctl = _controller(P, FakeClock(), slo_p99_s={"default": 0.5, "premium": 0.1})
    ctl._state("premium").tier = 3
    ctl._state("default").tier = 1
    idx, tier = ctl.tier_for_batch(["default", "premium", "default"])
    assert idx == 3 and tier is ctl.tiers[3]
    ctl._state("premium").tier = len(ctl.tiers)
    idx2, _ = ctl.tier_for_batch(["premium"])
    assert idx2 == len(ctl.tiers) - 1
    return idx, idx2, ctl.snapshot()


def _server(P, controller_kw=None, serve_kw=None, factory_kw=None):
    serve_kw = dict(serve_kw or {})
    serve_kw.setdefault("max_queue_depth", 256)
    serve_kw.setdefault("max_batch_size", 4)
    serve_kw.setdefault("batch_window_s", 0.005)
    serve_kw.setdefault("buckets", ((512, 512),))
    serve_kw.setdefault("default_steps", 4)
    serve_kw.setdefault("default_ttl_s", 10.0)
    ckw = dict(controller_kw or {})
    ckw.setdefault("enabled", True)
    ckw.setdefault("slo_p99_s", {"default": 0.2})
    ckw.setdefault("escalate_cooldown_s", 0.03)
    ckw.setdefault("retract_cooldown_s", 0.15)
    ckw.setdefault("service_prior_s", 0.08)
    config = P.ServeConfig(controller=P.ControllerConfig(**ckw), **serve_kw)
    fkw = dict(factory_kw or {})
    fkw.setdefault("batch_size", 4)
    fkw.setdefault("step_time_s", 0.02)
    factory = P.FakeExecutorFactory(**fkw)
    return P.InferenceServer(factory, config, model_id="m"), factory


def server_escalates_and_admission_rejects_typed(P):
    server, factory = _server(P)
    rejections = []
    with server:
        for i in range(300):
            try:
                server.submit("p", height=512, width=512, seed=i)
            except P.AdmissionRejectedError as exc:
                rejections.append(exc)
            except P.RetryableError:
                pass
            time.sleep(0.002)
        snap = server.metrics_snapshot()
    assert snap["controller"]["classes"]["default"]["transitions"] > 0
    disp = server.registry.counter("serve_controller_dispatches").snapshot()
    assert len(disp) > 1, disp
    assert rejections and all(isinstance(e, P.RetryableError) for e in rejections)
    assert snap["requests"]["rejected_admission"] == len(rejections)
    assert len({k.short() for k in factory.built}) > 1
    # every built key is a tier of the default table mapped from the bucket
    base = server._exec_key_for(512, 512, 4, cfg=True)
    tier_keys = {P.apply_tier(base, t).short(): t.name for t in P.DEFAULT_TIERS}
    assert {k.short() for k in factory.built} <= set(tier_keys)
    return (type(rejections[0]).__name__, str(rejections[0]),
            snap["controller"]["tiers"], sorted(disp) <= sorted(tier_keys.values()))


def server_retracts_to_full_when_idle(P):
    server, _ = _server(P)
    with server:
        for i in range(200):
            try:
                server.submit("p", height=512, width=512, seed=i)
            except P.RetryableError:
                pass
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            snap = server.metrics_snapshot()["controller"]
            tier = snap["classes"].get("default", {}).get("tier")
            if tier == 0 and len(server.queue) == 0:
                break
            time.sleep(0.05)
        assert tier == 0, snap
    trans = server.registry.counter("serve_controller_transitions").snapshot()
    assert any(k.startswith("escalate:") for k in trans)
    assert any(k.startswith("retract:") for k in trans)
    return tier, sorted({k.split(":")[0] for k in trans})


def controller_off_is_inert(P):
    server, factory = _server(P, controller_kw={"enabled": False})
    assert server.controller is None
    with server:
        r = server.submit("p", height=512, width=512).result(timeout=30)
        snap = server.metrics_snapshot()
    assert snap["controller"] is None and r.tier is None
    assert all(k.refresh_fraction == 1.0 and k.step_cache_interval == 1
               for k in factory.built)
    return r.exec_key, r.output.tobytes()


def rolling_quantile_max_age_decays(P):
    clock = FakeClock()
    rq = P.RollingQuantile(window=8, clock=clock, max_age_s=10.0)
    for v in (1.0, 2.0, 3.0):
        rq.observe(v)
    assert rq.snapshot()["window"] == 3 and rq.quantile(0.5) == 2.0
    clock.advance(5.0)
    rq.observe(9.0)
    clock.advance(6.0)
    snap = rq.snapshot()
    assert snap["window"] == 1 and snap["p99"] == 9.0 and snap["count"] == 4
    clock.advance(20.0)
    empty = rq.snapshot()
    assert empty["window"] == 0 and "p99" not in empty and empty["count"] == 4
    return snap, empty


def idle_server_slo_windows_decay(P):
    clock = FakeClock()
    config = P.ServeConfig(buckets=((512, 512),), max_batch_size=2,
                           observability=P.ObservabilityConfig(slo_window=16,
                                                               slo_max_age_s=30.0))
    server = P.InferenceServer(P.FakeExecutorFactory(batch_size=2), config, model_id="m",
                               clock=clock)
    server.slo_window("default").observe(1.5)
    first = server.slo_snapshot()["classes"]["default"]
    assert first["window"] == 1
    clock.advance(60.0)
    snap = server.slo_snapshot()["classes"]["default"]
    assert snap["window"] == 0 and "p99" not in snap
    return first, snap


def apply_key_policy_partial_refresh_gather_only(P):
    def stub(attn_impl):
        dcfg = types.SimpleNamespace(
            parallelism="patch", attn_impl=attn_impl, refresh_fraction=1.0,
            step_cache_interval=1, step_cache_depth=0, comm_compress="none",
            weight_quant="none")
        return types.SimpleNamespace(distri_config=dcfg)

    pipe = stub("gather")
    P.executors.apply_key_policy(pipe, key_for(P, refresh_fraction=0.5))
    assert pipe.distri_config.refresh_fraction == 0.5
    ring = stub("ring")
    ring.distri_config.refresh_fraction = 0.5
    P.executors.apply_key_policy(ring, key_for(P))
    assert ring.distri_config.refresh_fraction == 1.0
    with pytest.raises(ValueError, match="gather layout only"):
        P.executors.apply_key_policy(stub("ring"), key_for(P, refresh_fraction=0.5))
    return vars(pipe.distri_config), vars(ring.distri_config)


def registry_rolling_rejects_conflicting_aging(P):
    reg = P.MetricsRegistry()
    reg.rolling("w", window=8, max_age_s=10.0)
    with pytest.raises(ValueError, match="max_age_s") as info:
        reg.rolling("w", window=8, max_age_s=20.0)
    return str(info.value)


def prompt_cache_lru_and_counters(P):
    cache = P.PromptCache(2)
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


def prompt_cache_concurrent_get_or_encode(P):
    cache = P.PromptCache(8)
    n = [0]
    lock = threading.Lock()

    def enc():
        with lock:
            n[0] += 1
        return "v"

    threads = [threading.Thread(target=lambda: [cache.get_or_encode("k", enc)
                                                for _ in range(50)]) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cache.get_or_encode("k", enc) == "v"
    assert len(cache) == 1 and n[0] >= 1
    return len(cache)


def server_prompt_cache_hits_on_repeated_prompts(P):
    config = P.ServeConfig(buckets=((512, 512),), max_batch_size=2, batch_window_s=0.0,
                           pipeline_stages=True, prompt_cache_capacity=8)
    factory = P.StagedFakeExecutorFactory(batch_size=2, encode_s=0.0)
    with P.InferenceServer(factory, config, model_id="m") as server:
        a = server.submit("same prompt", height=512, width=512, seed=1).result(timeout=30)
        b = server.submit("same prompt", height=512, width=512, seed=1).result(timeout=30)
        snap = server.metrics_snapshot()
    assert snap["prompt_cache"]["hits"] >= 1 and snap["prompt_cache"]["misses"] >= 1
    np.testing.assert_array_equal(a.output, b.output)
    assert server.registry.counter("serve_prompt_cache").snapshot().get("hits", 0) >= 1
    return a.output.tobytes(), snap["prompt_cache"]


def controller_counts_prompt_cache_hit_as_cheaper_input(P):
    cache = P.PromptCache(4)
    cfg = P.ControllerConfig(enabled=True, slo_p99_s={"default": 0.5},
                             service_prior_s=0.1, encode_share=0.5)
    ctl = P.SLOController(cfg, clock=FakeClock(), batch_hint=4)
    ctl.prompt_cache = cache
    cache.get("k")
    assert ctl._effective_service() == pytest.approx(0.1)
    cache.put("k", 1)
    for _ in range(3):
        cache.get("k")
    assert ctl._effective_service() == pytest.approx(0.1 * (1 - 0.5 * 0.75))
    return round(ctl._effective_service(), 12)


def step_server_tiers_step_admissions(P):
    """The step pool's admission maps through the controller's tier (the
    JAX server's ``_step_request_key``), counts one dispatch a request,
    calibrates per step and names the tier in the result."""
    cfg = P.ServeConfig(
        buckets=((64, 64),), max_batch_size=4, batch_window_s=0.001, default_steps=4,
        warmup_buckets=(), max_queue_depth=32,
        step_batching=P.StepBatchConfig(enabled=True, slots=4),
        controller=P.ControllerConfig(enabled=True, slo_p99_s={"default": 10.0},
                                      escalate_cooldown_s=1e9, retract_cooldown_s=1e9))
    factory = P.StepFakeExecutorFactory(batch_size=4)
    with P.InferenceServer(factory, cfg, model_id="m") as server:
        server.controller._state("default").tier = 4
        rs = [f.result(timeout=30) for f in [server.submit(f"p{i}", height=64, width=64, seed=i)
                                             for i in range(3)]]
        snap = server.metrics_snapshot()
    assert all(r.tier == "reduced_steps" for r in rs)
    disp = server.registry.counter("serve_controller_dispatches").snapshot()
    assert disp == {"reduced_steps": 3}
    assert snap["controller"]["step_service_estimate_s"] is not None
    return ([(r.tier, r.exec_key, r.output.tobytes()) for r in rs], disp,
            snap["requests"]["steps_executed"])


SCENARIOS = {f.__name__: f for f in (
    tier_table_validation, apply_tier_key_mapping, exec_key_refresh_fraction_validation,
    ladder_rungs_win_over_controller_tier, escalates_under_load_one_rung_per_cooldown,
    retracts_when_load_drops, hysteresis_no_flap_at_boundary,
    measured_breach_escalates_only_under_live_load, replayed_load_is_deterministic,
    service_calibration_normalizes_by_tier_cost, tier_for_batch_takes_cheapest_needed,
    server_escalates_and_admission_rejects_typed, server_retracts_to_full_when_idle,
    controller_off_is_inert, rolling_quantile_max_age_decays, idle_server_slo_windows_decay,
    apply_key_policy_partial_refresh_gather_only, registry_rolling_rejects_conflicting_aging,
    prompt_cache_lru_and_counters, prompt_cache_concurrent_get_or_encode,
    server_prompt_cache_hits_on_repeated_prompts,
    controller_counts_prompt_cache_hit_as_cheaper_input, step_server_tiers_step_admissions)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_scenario_matches_jax(name):
    # the two packages' runs overlap on two threads: the scenarios wait on
    # sleeps, sockets and fakes, not on the CPU
    pkgs = [pkg(n) for n in PACKAGES]
    with ThreadPoolExecutor(2) as pool:
        want, got = [f.result() for f in [pool.submit(SCENARIOS[name], P) for P in pkgs]]
    assert got == want


@pytest.mark.parametrize("parallelism", ["patch", "pipefusion"])
def test_apply_tier_every_default_tier_matches_jax(parallelism):
    J, T = pkg(PACKAGES[0]), pkg(PACKAGES[1])
    kw = dict(parallelism=parallelism, pipe_patches=2) if parallelism == "pipefusion" else {}
    assert [dataclasses.astuple(t) for t in T.DEFAULT_TIERS] == \
        [dataclasses.astuple(t) for t in J.DEFAULT_TIERS]
    for steps in (1, 4, 7):
        for jt, pt in zip(J.DEFAULT_TIERS, T.DEFAULT_TIERS):
            want = J.apply_tier(key_for(J, steps=steps, **kw), jt)
            got = T.apply_tier(key_for(T, steps=steps, **kw), pt)
            assert key_fields(got) == key_fields(want)
            assert got.short() == want.short()


# -- the tiny SDXL pipeline held at the reduced_steps tier ---------------------


from test_torch_port_serve_pipeline import (  # noqa: E402
    SDXL_TOL, _jax_sdxl, _port_sdxl, sdxl_trees)  # noqa: F401 -- fixture

BASE_STEPS = 4


def _tier_fields(key):
    return dict(step_cache_interval=key.step_cache_interval,
                step_cache_depth=key.step_cache_depth,
                comm_compress=key.comm_compress, refresh_fraction=key.refresh_fraction)


def _held_server(P, factory):
    """A server whose controller holds the default class at reduced_steps
    (cooldowns past any run, so no poll moves it)."""
    config = P.ServeConfig(
        buckets=((128, 128),), max_batch_size=2, batch_window_s=0.2,
        default_steps=BASE_STEPS, warmup_buckets=(),
        controller=P.ControllerConfig(enabled=True, slo_p99_s={"default": 60.0},
                                      escalate_cooldown_s=1e9, retract_cooldown_s=1e9))
    server = P.InferenceServer(factory, config, model_id="tiny-sdxl")
    server.controller._state("default").tier = [t.name for t in server.controller.tiers
                                                ].index("reduced_steps")
    return server


REQUESTS = [("a lighthouse at dusk", 21), ("a corgi on a skateboard", 22)]


def test_reduced_steps_tier_serves_its_solo_image_and_matches_jax(devices8, sdxl_trees):
    from distrifuser_tpu import DistriConfig as JaxDistriConfig
    from distrifuser_tpu.serve.executors import pipeline_executor_factory as jax_factory
    from distrifuser_tpu_torch.serve import pipeline_executor_factory

    T, J = pkg(PACKAGES[1]), pkg(PACKAGES[0])
    lat = {s: np.random.RandomState(s).randn(1, 16, 16, 4).astype(np.float32)
           for _, s in REQUESTS}
    built = {}

    def port_build(key):
        built["pipe"] = _port_sdxl(sdxl_trees, **_tier_fields(key))
        return built["pipe"]

    def port_factory(key, _inner=pipeline_executor_factory(port_build)):
        ex = _inner(key)
        built["key"] = key
        return ex

    server = _held_server(T, port_factory)
    with server:
        futs = [server.submit(p, height=128, width=128, seed=s) for p, s in REQUESTS]
        results = [f.result(timeout=120) for f in futs]
    key = built["key"]
    assert key.steps == BASE_STEPS // 2 and key.comm_compress == "int8"
    assert (key.step_cache_interval, key.step_cache_depth, key.refresh_fraction) == (2, 1, 0.5)
    pipe = built["pipe"]
    assert pipe.distri_config.step_cache_interval == 2
    for (prompt, seed), r in zip(REQUESTS, results):
        assert r.tier == "reduced_steps" and r.exec_key == key.short()
        solo = pipe(prompt, seed=seed, num_inference_steps=key.steps,
                    output_type="np").images[0]
        np.testing.assert_array_equal(r.output, solo)

    # the JAX package's server held at the tier, fed initial latents of its
    # own, against the tier pipeline's solo calls from the same latents
    sigma = float(pipe.scheduler.init_noise_sigma)
    lat = {s: np.random.RandomState(s).randn(1, 16, 16, 4).astype(np.float32) * sigma
           for _, s in REQUESTS}
    want = np.stack([pipe(p, latents=torch.from_numpy(lat[s]), num_inference_steps=key.steps,
                          output_type="np").images[0] for p, s in REQUESTS])
    unet, vae, text = sdxl_trees

    def jax_build(key):
        from distrifuser_tpu import pipelines as jp
        from distrifuser_tpu.models import clip as jc, unet as ju, vae as jv
        from test_torch_port_pipeline import _text_configs

        cfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128, warmup_steps=1,
                              batch_size=2, use_cuda_graph=False, **_tier_fields(key))
        return jp.DistriSDXLPipeline.from_params(
            cfg, ju.tiny_config(cross_attention_dim=32, sdxl=True), unet,
            jv.tiny_vae_config(), vae, _text_configs(jc), text)

    def jax_fixed(key, _inner=jax_factory(jax_build)):
        ex = _inner(key)
        ex._draw_latents = lambda seeds: np.concatenate([lat[s] for s in seeds])
        return ex

    with _held_server(J, jax_fixed) as srv:
        rs = [f.result(timeout=300) for f in
              [srv.submit(p, height=128, width=128, seed=s) for p, s in REQUESTS]]
    assert all(r.tier == "reduced_steps" for r in rs)
    np.testing.assert_allclose(np.stack([np.asarray(r.output) for r in rs]), want,
                               rtol=0, atol=SDXL_TOL)
