"""PyTorch port: the serve plane's whole-batch path against the JAX package's.

Each scenario runs once per package through the same `ServeConfig`, the
same requests, the same seeded `FaultPlan` and the weightless fake
executors (serve/testing.py), and the records must be equal: each result's
image bytes and audit fields or its error type, the batch sizes, the cache
hits, misses and evictions, the degradation rungs, the breaker states and
the keys of ``health()`` and ``metrics_snapshot()``.  Batching is made
deterministic by a gate: the first request's dispatch blocks until every
other request of the scenario is queued (``submit`` refuses before
``start()`` in both packages).  The pure pieces (bucket snapping,
``ExecKey.short()``, the degradation ladder, seeded backoff, the
Prometheus text of one registry) are compared case by case, and the
configs field for field.
"""

import dataclasses
import importlib
import threading
import time

import numpy as np
import pytest

PACKAGES = ("distrifuser_tpu", "distrifuser_tpu_torch")


def _mods(pkg):
    serve = importlib.import_module(f"{pkg}.serve")
    return (serve, importlib.import_module(f"{pkg}.serve.testing"),
            importlib.import_module(f"{pkg}.utils.config"))


class Gate:
    """Wraps a package's fake factory: the executors it builds block their
    first call until ``release()`` -- every request submitted meanwhile is
    queued, so the batches that follow form from a known backlog."""

    def __init__(self, inner):
        self.inner = inner
        self.entered = threading.Event()
        self.opened = threading.Event()
        self.armed = True

    def release(self):
        assert self.entered.wait(10), "the gated dispatch never started"
        self.opened.set()

    def __call__(self, key):
        ex = self.inner(key)
        gate = self

        class Gated:
            batch_size = ex.batch_size
            shallow_steps = ex.shallow_steps

            def __call__(self, *args):
                if gate.armed:
                    gate.armed = False
                    gate.entered.set()
                    assert gate.opened.wait(10)
                return ex(*args)

        return Gated()


def _wait_inflight(server):
    t = time.monotonic() + 10
    while server.slo_snapshot()["inflight_requests"] < 1 or len(server.queue):
        assert time.monotonic() < t, "the first dispatch never started"
        time.sleep(0.005)


def _outcome(fut):
    try:
        r = fut.result(timeout=30)
    except Exception as exc:  # noqa: BLE001 -- the record is the type
        return ("err", type(exc).__name__)
    return ("ok", np.asarray(r.output).tobytes(), r.bucket, r.requested_size,
            r.batch_size, r.compile_hit, r.retries, tuple(r.degradations), r.exec_key)


def _config(cfg_mod, resilience=None, **kw):
    kw.setdefault("max_queue_depth", 16)
    kw.setdefault("max_batch_size", 2)
    kw.setdefault("batch_window_s", 0.0)
    kw.setdefault("buckets", ((512, 512), (1024, 1024)))
    kw.setdefault("default_steps", 4)
    if resilience is not None:
        kw["resilience"] = cfg_mod.ResilienceConfig(**resilience)
    return cfg_mod.ServeConfig(**kw)


# Each scenario: (config kwargs, resilience kwargs, fault rules, script).
# A script is a list of steps: ("gated", [requests]) submits the first
# request, waits until its dispatch blocks, submits the rest and opens the
# gate; ("each", [requests]) submits one at a time and waits for each; a
# request is (prompt, height, width, seed, extra submit kwargs);
# ("sleep", s) waits.
def _reqs(n, h=512, w=512, base=0, **kw):
    return [(f"prompt {base + i}", h, w, base + i, kw) for i in range(n)]


SCENARIOS = {
    "coalescing": ({"warmup_buckets": ((512, 512),)}, None, (),
                   [("gated", _reqs(6))]),
    "queue_full": ({"max_queue_depth": 2, "max_batch_size": 1}, None, (),
                   [("gated", _reqs(4))]),
    "deadline_expiry": ({}, None, (),
                        [("gated", _reqs(1) + _reqs(1, base=1, ttl_s=0.05)
                          + _reqs(1, base=2)), ]),
    "bucket_snap": ({}, None, (),
                    [("each", [("a", 500, 300, 1, {}), ("b", 768, 640, 2, {}),
                               ("c", 4096, 4096, 3, {}), ("d", 512, 512, 4, {}),
                               ("e", 1024, 1024, 5, {})])]),
    "lru_eviction": ({"cache_capacity": 1}, None, (),
                     [("each", _reqs(1) + _reqs(1, 1024, 1024, base=1)
                       + _reqs(1, base=2) + _reqs(1, base=3))]),
    "oom_split_weight_quant": (
        {}, {"allow_stepwise_fallback": False, "allow_weight_quant_on": True,
             "backoff_base_s": 0.001, "backoff_max_s": 0.01},
        ({"site": "execute", "kind": "oom", "at_calls": (1, 2)},),
        [("gated", _reqs(3))]),
    "breaker_open_then_shed": (
        {}, {"max_retries": 0, "breaker_failure_threshold": 2,
             "breaker_cooldown_s": 600.0},
        ({"site": "execute", "kind": "execute_error", "p": 1.0},),
        [("each", _reqs(4))]),
    "watchdog_timeout": (
        {}, {"max_retries": 0, "watchdog_timeout_s": 0.15},
        ({"site": "execute", "kind": "hang", "at_calls": (0,), "hang_s": 0.6},),
        [("each", _reqs(1)), ("sleep", 0.7), ("each", _reqs(1, base=1))]),
}


def run_scenario(pkg, name):
    serve, testing, cfg_mod = _mods(pkg)
    cfg_kw, res_kw, rules, script = SCENARIOS[name]
    config = _config(cfg_mod, res_kw, **cfg_kw)
    plan = (serve.FaultPlan([serve.FaultRule(**r) for r in rules], seed=7)
            if rules else None)
    factory = testing.FakeExecutorFactory(batch_size=2)
    gate = Gate(factory)
    server = serve.InferenceServer(gate, config, model_id="m", scheduler="ddim",
                                   fault_plan=plan)
    outcomes, submit_errors = [], []

    def submit(req):
        prompt, h, w, seed, kw = req
        try:
            return server.submit(prompt, height=h, width=w, seed=seed, **kw)
        except Exception as exc:  # noqa: BLE001 -- recorded by type
            submit_errors.append((prompt, type(exc).__name__))
            return None

    with server:
        if not any(kind == "gated" for kind, _ in script):
            gate.armed = False
        for kind, arg in script:
            if kind == "sleep":
                time.sleep(arg)
            elif kind == "each":
                for req in arg:
                    fut = submit(req)
                    outcomes.append(None if fut is None else _outcome(fut))
            else:
                futs = [submit(arg[0])]
                _wait_inflight(server)
                futs += [submit(req) for req in arg[1:]]
                if any(len(req[4]) for req in arg):
                    time.sleep(0.1)  # let the short deadlines lapse in the queue
                gate.release()
                outcomes += [None if f is None else _outcome(f) for f in futs]
        health = server.health()
        snap = server.metrics_snapshot()
    res = snap["resilience"]
    return {
        "outcomes": outcomes,
        "submit_errors": submit_errors,
        "batch_sizes": factory.batch_sizes(),
        "built": [k.short() for k in factory.built],
        "cache": {k: snap["cache"][k] for k in ("hits", "misses", "evictions", "entries")},
        "requests": snap["requests"],
        "batch_hist": snap["batch_size"]["hist"],
        "degradations": res["degradations"],
        "circuits": {k: v["state"] for k, v in res["circuits"].items()},
        "open_circuits": res["open_circuits"],
        "watchdog_timeouts": res["watchdog_timeouts"],
        "fired": plan.fired() if plan else {},
        "health_keys": sorted(health),
        "health_status": health["status"],
        "snapshot_keys": sorted(snap),
        "resilience_keys": sorted(res),
    }


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fake_server_matches_jax(name):
    want = run_scenario(PACKAGES[0], name)
    got = run_scenario(PACKAGES[1], name)
    assert got == want
    # each scenario shows what it is about
    if name == "coalescing":
        assert got["batch_sizes"] == [1, 2, 2, 1] and got["cache"]["misses"] == 1
    elif name == "queue_full":
        assert got["submit_errors"] == [("prompt 3", "QueueFullError")]
    elif name == "deadline_expiry":
        assert [o[0] if o[0] == "ok" else o[1] for o in got["outcomes"]] == [
            "ok", "DeadlineExceededError", "ok"]
    elif name == "bucket_snap":
        assert [o[2] if o[0] == "ok" else o[1] for o in got["outcomes"]] == [
            (512, 512), (1024, 1024), "NoBucketError", (512, 512), (1024, 1024)]
    elif name == "lru_eviction":
        assert got["cache"]["evictions"] == 2 and got["cache"]["misses"] == 3
    elif name == "oom_split_weight_quant":
        (rungs,) = [d["rungs"] for d in got["degradations"].values()]
        assert rungs == ["weight_quant_on"]
        assert got["outcomes"][-1][7] == ("weight_quant_on",)
        assert ":wq-int8" in got["outcomes"][-1][8]
    elif name == "breaker_open_then_shed":
        assert [o[1] for o in got["outcomes"]] == [
            "ExecuteFailedError", "ExecuteFailedError", "CircuitOpenError",
            "CircuitOpenError"]
        assert list(got["circuits"].values()) == ["open"]
    elif name == "watchdog_timeout":
        assert got["outcomes"][0] == ("err", "WatchdogTimeoutError")
        assert got["outcomes"][1][0] == "ok" and got["watchdog_timeouts"] == 1


# --------------------------------------------------------------------------
# the pure pieces, case by case
# --------------------------------------------------------------------------

SNAP_CASES = [(512, 512), (500, 300), (513, 512), (600, 1200), (1024, 1024),
              (2048, 1000), (4096, 4096), (8, 8)]


@pytest.mark.parametrize("hw", SNAP_CASES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_bucket_snap_matches_jax(hw):
    def snap(pkg):
        serve, _, cfg_mod = _mods(pkg)
        table = serve.BucketTable(cfg_mod.DEFAULT_BUCKETS)
        try:
            return table.snap(*hw)
        except serve.NoBucketError as exc:
            return str(exc)

    assert snap(PACKAGES[1]) == snap(PACKAGES[0])


KEY_CASES = [
    {},
    {"cfg": False, "steps": 50},
    {"step_cache_interval": 2, "step_cache_depth": 1},
    {"comm_compress": "int8", "refresh_fraction": 0.5},
    {"weight_quant": "int8", "quant_compute": "pallas"},
    {"weight_quant": "fp8"},
    {"exec_mode": "stepwise"},
    {"parallelism": "pipefusion", "pipe_patches": 4},
    {"mesh_plan": "dp2.cfg2.sp2", "scheduler": "flow-euler"},
]


@pytest.mark.parametrize("fields", KEY_CASES, ids=lambda f: ",".join(f) or "default")
def test_exec_key_short_matches_jax(fields):
    def short(pkg):
        serve = _mods(pkg)[0]
        base = dict(model_id="m", scheduler="ddim", height=1024, width=1024, steps=4,
                    cfg=True, mesh_plan="dp1.cfg1.sp1")
        return serve.ExecKey(**{**base, **fields}).short()

    assert short(PACKAGES[1]) == short(PACKAGES[0])


BAD_KEYS = [{"exec_mode": "bogus"}, {"comm_compress": "int4"},
            {"refresh_fraction": 0.3}, {"weight_quant": "int4"},
            {"pipe_patches": 2}, {"parallelism": "pipefusion", "exec_mode": "stepwise"}]


@pytest.mark.parametrize("fields", BAD_KEYS,
                         ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_exec_key_refusals_match_jax(fields):
    def refusal(pkg):
        serve = _mods(pkg)[0]
        base = dict(model_id="m", scheduler="ddim", height=1024, width=1024, steps=4,
                    cfg=True, mesh_plan="dp1.cfg1.sp1")
        with pytest.raises(ValueError) as info:
            serve.ExecKey(**{**base, **fields})
        return str(info.value)

    assert refusal(PACKAGES[1]) == refusal(PACKAGES[0])


LADDER_CASES = [
    ({}, {}, "oom", 4),
    ({}, {}, "oom", 1),
    ({}, {}, "compile", 4),
    ({"allow_weight_quant_on": True, "allow_stepwise_fallback": False}, {}, "oom", 1),
    ({"allow_bucket_fallback": True, "allow_weight_quant_on": True},
     {"step_cache_interval": 2, "step_cache_depth": 1}, "compile", 1),
    ({"allow_batch_split": False, "max_degradations": 1}, {"parallelism": "pipefusion"},
     "oom", 2),
    ({}, {}, "transient", 2),
]


@pytest.mark.parametrize("case", range(len(LADDER_CASES)))
def test_degradation_ladder_matches_jax(case):
    cfg_kw, key_kw, kind, batch = LADDER_CASES[case]

    def walk(pkg):
        serve, _, cfg_mod = _mods(pkg)
        res = importlib.import_module(f"{pkg}.serve.resilience")
        ladder = serve.DegradationLadder(cfg_mod.ResilienceConfig(**cfg_kw),
                                         buckets=((512, 512), (1024, 1024)))
        key = serve.ExecKey(model_id="m", scheduler="ddim", height=1024, width=1024,
                            steps=4, cfg=True, mesh_plan="dp1.cfg1.sp1", **key_kw)
        state = res.KeyResilience(breaker=serve.CircuitBreaker(1, 1.0))
        seq, n = [], batch
        for _ in range(8):
            rung = ladder.next_rung(state, kind, key, n)
            if rung is None:
                break
            if rung != res.RUNG_SPLIT:
                state.rungs.append(rung)
            seq.append((rung, ladder.apply(key, state.rungs).short()))
            if rung == res.RUNG_SPLIT:
                n = max(1, n // 2)
        return seq

    assert walk(PACKAGES[1]) == walk(PACKAGES[0])


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_backoff_delays_match_jax(seed):
    def delays(pkg):
        policy = _mods(pkg)[0].BackoffPolicy(0.05, 2.0, 2.0, 0.1, seed=seed)
        return policy.schedule(8)

    assert delays(PACKAGES[1]) == delays(PACKAGES[0])


def test_prometheus_text_matches_jax():
    def render(pkg):
        serve = _mods(pkg)[0]
        clock = iter(np.arange(0.0, 100.0, 0.5)).__next__
        reg = serve.MetricsRegistry()
        c = reg.counter("serve_requests")
        c.inc("submitted", 3)
        c.inc("completed")
        h = reg.histogram("serve_latency_seconds", labels={"phase": "e2e"})
        for v in (0.01, 0.2, 0.2, 3.0, 0.0005):
            h.observe(v)
        reg.gauge("serve_queue_depth", lambda: 2.0)
        reg.gauge("serve_set_gauge").set(1.5)
        r = reg.rolling("serve_slo_e2e_seconds", window=4,
                        labels={"slo_class": "default"}, clock=clock, max_age_s=1e6)
        for v in (0.3, 0.1, 0.2, 0.4, 0.5):
            r.observe(v)
        reg.scoped({"replica": "r0"}).counter("scoped").inc("x")
        reg.ring("errors").add("boom")
        return reg.to_prometheus(), reg.snapshot()

    assert render(PACKAGES[1]) == render(PACKAGES[0])


def _fields(obj):
    return [(f.name, f.default if f.default is not dataclasses.MISSING else "factory")
            for f in dataclasses.fields(obj)]


@pytest.mark.parametrize("name", ["ServeConfig", "ResilienceConfig", "ObservabilityConfig",
                                  "StepBatchConfig", "ControllerConfig", "AotCacheConfig",
                                  "GatewayConfig", "TenantConfig"])
def test_configs_match_jax_field_for_field(name):
    jcfg, pcfg = (_mods(pkg)[2] for pkg in PACKAGES)
    assert _fields(getattr(pcfg, name)) == _fields(getattr(jcfg, name))
    if name != "TenantConfig":
        j, p = getattr(jcfg, name)(), getattr(pcfg, name)()
        assert repr(p) == repr(j)
    assert pcfg.DEFAULT_BUCKETS == jcfg.DEFAULT_BUCKETS


def test_serve_config_defaults_and_tiers_match_jax():
    jcfg, pcfg = (_mods(pkg)[2] for pkg in PACKAGES)
    j, p = jcfg.ServeConfig(), pcfg.ServeConfig()
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(p, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    with pytest.raises(ValueError, match="multiples of 8"):
        pcfg.ServeConfig(buckets=((500, 500),))
    with pytest.raises(ValueError, match="tier costs must strictly decrease"):
        pcfg.ControllerConfig(tiers=({"name": "full", "cost": 1.0},
                                     {"name": "b", "cost": 1.0}))


def test_mesh_plan_matches_jax(devices8):
    from distrifuser_tpu import DistriConfig as JaxDistriConfig
    from distrifuser_tpu_torch import DistriConfig

    assert (DistriConfig(device="cpu").mesh_plan
            == JaxDistriConfig(devices=devices8[:1]).mesh_plan == "dp1.cfg1.sp1")


# --------------------------------------------------------------------------
# the port alone: OOM classification, the watchdog rule, the refusals
# --------------------------------------------------------------------------


def test_is_oom_sees_torch_cuda_oom():
    import torch

    from distrifuser_tpu_torch.serve import ResourceExhaustedError, is_oom
    from distrifuser_tpu_torch.serve.faults import InjectedResourceExhausted

    assert is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert is_oom(RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert is_oom(InjectedResourceExhausted("RESOURCE_EXHAUSTED: injected oom"))
    assert is_oom(ResourceExhaustedError("typed"))
    assert not is_oom(RuntimeError("CUDA error: an illegal memory access"))


def test_real_oom_walks_the_ladder_and_drops_the_failed_frames():
    """An executor raising ``torch.cuda.OutOfMemoryError`` (what the caching
    allocator raises) is classified OOM, answered by weight_quant_on, and
    what its frame held is released before the int8 key is built."""
    import gc
    import weakref

    import torch

    serve, testing, cfg_mod = _mods(PACKAGES[1])
    held = {}

    class Boom:
        batch_size = 2
        shallow_steps = 0

        def __call__(self, *args):
            big = torch.zeros(1 << 16)  # what the failed call allocated
            held["ref"] = weakref.ref(big)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")

    alive_at_rebuild = []

    def factory(key):
        if key.weight_quant == "none":
            return Boom()
        alive_at_rebuild.append(held["ref"]() is not None)
        return testing.FakeExecutor(key, batch_size=2)

    gc.disable()  # the frames must go by reference counting, not a collection
    try:
        config = _config(cfg_mod, {"allow_batch_split": False,
                                   "allow_stepwise_fallback": False,
                                   "allow_weight_quant_on": True, "backoff_base_s": 0.001,
                                   "backoff_max_s": 0.01})
        with serve.InferenceServer(factory, config, model_id="m") as server:
            r = server.submit("p", height=512, width=512, seed=3).result(timeout=30)
            health = server.health()
    finally:
        gc.enable()
    assert r.degradations == ("weight_quant_on",) and ":wq-int8" in r.exec_key
    assert alive_at_rebuild == [False]
    (entry,) = health["degradations"].values()
    assert entry["rungs"] == ["weight_quant_on"]
    assert "CUDA out of memory" in health["last_errors"][0]["message"]


def test_watchdog_never_dispatches_over_an_abandoned_worker():
    from distrifuser_tpu_torch.serve import Watchdog, WatchdogTimeoutError

    release, running = threading.Event(), []

    def stuck():
        running.append("stuck")
        release.wait(10)
        running.remove("stuck")
        return "late"

    dog = Watchdog(timeout_s=0.5)
    with pytest.raises(WatchdogTimeoutError, match="watchdog bound"):
        dog.run(stuck)
    calls = []
    # the next dispatch waits one more bound for the abandoned worker, then
    # sheds without running: the card never runs two dispatches at once
    with pytest.raises(WatchdogTimeoutError, match="previously abandoned"):
        dog.run(lambda: calls.append(list(running)))
    assert calls == [] and running == ["stuck"]
    release.set()
    assert dog.run(lambda: list(running)) == []
    assert dog.timeouts == 2


# the settings of later steps of ROADMAP item 16: refused naming the step
# until it is ported; None once it is (16b to 16f: accepted, and run)
REFUSALS = {
    "pipeline_stages": (lambda c: {"pipeline_stages": True}, None),
    "prompt_cache": (lambda c: {"prompt_cache_capacity": 4}, None),
    "step_batching": (lambda c: {"step_batching": c.StepBatchConfig(enabled=True)}, None),
    "controller": (lambda c: {"controller": c.ControllerConfig(enabled=True)}, None),
    "tenants": (lambda c: {"gateway": c.GatewayConfig(tenants=(c.TenantConfig(name="a"),))},
                None),
    "gateway": (lambda c: {"gateway": c.GatewayConfig(port=0)}, None),
    "ranks_pipeline_stages": (lambda c: {"pipeline_stages": True}, None),
    "ranks_step_batching": (lambda c: {"step_batching": c.StepBatchConfig(enabled=True)},
                            None),
    "aot_cache": (lambda c: {"aot_cache": c.AotCacheConfig(dir="store")}, "16g"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_unported_settings_are_refused(name):
    """Since steps 16d and 16e the controller, a tenant table and the
    gateway serve, and since 16f staging and step batching serve over a
    ``mesh_plan`` of more than one rank; the AOT store (16g) is still
    refused, naming the step."""
    fields, step = REFUSALS[name]
    serve, testing, cfg_mod = _mods(PACKAGES[1])
    config = cfg_mod.ServeConfig(**fields(cfg_mod))  # accepted, as in the JAX package
    mesh_plan = "dp1.cfg2.sp2" if name.startswith("ranks_") else "dp1.cfg1.sp1"
    if step is not None:
        with pytest.raises(ValueError, match=f"ROADMAP item 16, step {step}"):
            serve.InferenceServer(testing.FakeExecutorFactory(), config, mesh_plan=mesh_plan)
        return
    # ported: the server runs with the setting on and serves a request
    factory = (testing.StepFakeExecutorFactory() if name.endswith("step_batching")
               else testing.StagedFakeExecutorFactory())
    with serve.InferenceServer(factory, config, mesh_plan=mesh_plan) as server:
        r = server.submit("p", height=512, width=512, seed=3).result(timeout=30)
        snap = server.metrics_snapshot()
        gateway = server.gateway_endpoint
        assert (gateway is not None and gateway.port > 0) == (name == "gateway")
    assert np.array_equal(r.output, testing.fake_image("p", 3, factory.built[0]))
    assert server.aot_store is None
    block = {"pipeline_stages": "staging", "prompt_cache": "prompt_cache",
             "step_batching": "step_batching", "controller": "controller",
             "tenants": "tenancy", "gateway": "requests",
             "ranks_pipeline_stages": "staging",
             "ranks_step_batching": "step_batching"}[name]
    assert factory.built[0].mesh_plan == mesh_plan
    assert snap[block] is not None
    assert (snap["controller"] is None) == (name != "controller")
    assert (snap["tenancy"] is None) == (name != "tenants")
    if name == "controller":
        assert r.tier == "full"


def test_step_exec_key_and_carry_import_are_refused():
    """Since step 16c a step key builds and a carry snapshot imports on a
    step-batching server; a whole-batch server still refuses an import
    (typed, as the JAX one does), and a broken snapshot is refused at
    submit."""
    serve, testing, cfg_mod = _mods(PACKAGES[1])
    server = serve.InferenceServer(testing.FakeExecutorFactory(), _config(cfg_mod))
    key = serve.ExecKey(model_id="m", scheduler="ddim", height=512, width=512, steps=4,
                        cfg=True, mesh_plan="dp1.cfg1.sp1", exec_mode="step")
    ex, hit = server.cache.get(key)
    assert not hit and ex.key.exec_mode == "step"
    with server:
        with pytest.raises(serve.MigrationRejectedError, match="step-level"):
            server.submit("p", height=512, width=512, carry_snapshot=b"x")
    step = serve.InferenceServer(
        testing.StepFakeExecutorFactory(),
        _config(cfg_mod, step_batching=cfg_mod.StepBatchConfig(enabled=True)))
    with step:
        with pytest.raises(serve.MigrationRejectedError, match="truncated"):
            step.submit("p", height=512, width=512, carry_snapshot=b"x")


def test_staging_and_step_batching_above_one_rank_are_refused():
    """Refused until step 16f; since then accepted over a layout of four
    ranks, each serving a request (tests/test_torch_port_serve_ranks.py and
    _step_ranks.py serve them over real gloo ranks)."""
    serve, testing, cfg_mod = _mods(PACKAGES[1])
    for fields, factory in (({"pipeline_stages": True}, testing.StagedFakeExecutorFactory()),
                            ({"step_batching": cfg_mod.StepBatchConfig(enabled=True)},
                             testing.StepFakeExecutorFactory())):
        with serve.InferenceServer(factory, _config(cfg_mod, **fields),
                                   mesh_plan="dp2.cfg1.sp2") as server:
            r = server.submit("p", height=512, width=512, seed=4).result(timeout=30)
        assert "dp2.cfg1.sp2" in r.exec_key.split(":")
        assert np.array_equal(r.output, testing.fake_image("p", 4, factory.built[0]))


def test_demo_runs():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-m", "distrifuser_tpu_torch.serve", "--demo"],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "[FAIL]" not in out.stdout and out.stdout.count("[ok]") == 5


def test_dense_service_names_the_int8_rungs_compute():
    """The port's one divergence from the JAX serve configs: a dense
    service may name the quantized-compute policy of its weight_quant_on
    rung (the JAX ExecKey documents this and refuses it, ROADMAP queue 3):
    the dense key's identity ignores it, the int8 key carries it."""
    serve, testing, cfg_mod = _mods(PACKAGES[1])
    jserve, _, jcfg = _mods(PACKAGES[0])
    with pytest.raises(ValueError, match="holds no quantized kernels"):
        jcfg.ServeConfig(quant_compute="pallas")
    with pytest.raises(ValueError, match="quant_compute must be one of"):
        cfg_mod.ServeConfig(quant_compute="bogus")
    fields = dict(model_id="m", scheduler="ddim", height=512, width=512, steps=4, cfg=True,
                  mesh_plan="dp1.cfg1.sp1")
    dense = serve.ExecKey(**fields, quant_compute="pallas")
    assert dense.short() == jserve.ExecKey(**fields).short()
    config = _config(cfg_mod, {"allow_batch_split": False, "allow_stepwise_fallback": False,
                               "allow_weight_quant_on": True, "backoff_base_s": 0.001,
                               "backoff_max_s": 0.01}, quant_compute="pallas")
    plan = serve.FaultPlan([serve.FaultRule(site="execute", kind="oom", at_calls=(0,))])
    factory = testing.FakeExecutorFactory(batch_size=2)
    with serve.InferenceServer(factory, config, model_id="m", fault_plan=plan) as server:
        r = server.submit("p", height=512, width=512).result(timeout=30)
    assert r.exec_key == dense.short() + ":wq-int8:qc-pallas"
    assert [k.quant_compute for k in factory.built] == ["pallas", "pallas"]
