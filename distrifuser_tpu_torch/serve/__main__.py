"""CPU-only serve demo: ``python -m distrifuser_tpu_torch.serve --demo``.

Drives the REAL scheduler (queue, batcher, bucket table, compiled-executable
cache, metrics) with the weightless fake executor, and self-checks the
serving invariants the subsystem exists for:

1. concurrent requests coalesce (some batched invocation has >= 2 requests);
2. after warmup the compiled cache only misses on first use of each bucket
   (hit rate > 0, misses == distinct buckets touched);
3. the per-request latency/queue metrics JSON artifact is emitted.

Exit code 0 only if all three hold — the demo doubles as an end-to-end
smoke test on any box, no weights or accelerator required.

The JAX package's ``--gateway-port`` / ``--tenants`` demo of its HTTP/SSE
gateway comes with a later step of ROADMAP item 16.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils import sync
from ..utils.config import ObservabilityConfig, ServeConfig
from .server import InferenceServer
from .testing import FakeExecutorFactory


def run_demo(metrics_path: str = None, verbose: bool = True,
             metrics_port: int = None, hold_s: float = 0.0,
             trace_out: str = None, dump_dir: str = None) -> int:
    config = ServeConfig(
        max_queue_depth=32,
        max_batch_size=4,
        batch_window_s=0.15,
        buckets=((512, 512), (1024, 1024)),
        warmup_buckets=((512, 512, 4),),
        default_steps=4,
        cache_capacity=4,
        observability=ObservabilityConfig(
            trace=bool(trace_out or dump_dir),
            metrics_port=metrics_port,
        ),
    )
    factory = FakeExecutorFactory(
        batch_size=4, build_delay_s=0.2, step_time_s=0.02
    )
    say = print if verbose else (lambda *a, **k: None)
    server = InferenceServer(
        factory, config, model_id="demo-sdxl", scheduler="ddim",
        mesh_plan="dp1.cfg2.sp4",
    )
    say("starting server (warmup compiles the 512x512 bucket)...")
    with server:
        if server.metrics_endpoint is not None:
            say(f"metrics endpoint: {server.metrics_endpoint.url}/metrics "
                f"(+ /metrics.json, /healthz)")
        # two waves of concurrent submissions: wave 1 lands in the warmed
        # 512 bucket; wave 2 mixes in 768x640 requests that snap to the
        # 1024x1024 bucket (its first use = the only other compile)
        futures = []
        lock = sync.Lock()

        def client(prompt, h, w, seed):
            f = server.submit(prompt, height=h, width=w, seed=seed)
            with lock:
                futures.append((prompt, h, w, f))

        waves = [
            [(f"a photo of a corgi #{i}", 512, 512, i) for i in range(4)],
            [(f"a watercolor skyline #{i}", 768, 640, 10 + i)
             for i in range(3)]
            + [(f"a photo of a corgi #{i}", 512, 512, 20 + i)
               for i in range(2)],
        ]
        for wave in waves:
            threads = [sync.Thread(target=client, args=a) for a in wave]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            # let the wave coalesce and finish before the next arrives
            for _, _, _, f in list(futures):
                f.result(timeout=30)

        say(f"\n{'request':34s} {'bucket':>11s} {'batch':>5s} "
            f"{'hit':>4s} {'wait_ms':>8s} {'e2e_ms':>7s}")
        for prompt, h, w, f in futures:
            r = f.result(timeout=30)
            say(f"{prompt:34s} {r.bucket[0]:4d}x{r.bucket[1]:<4d} "
                f"{r.batch_size:5d} {str(r.compile_hit):>4s} "
                f"{r.queue_wait_s * 1e3:8.1f} {r.e2e_s * 1e3:7.1f}")

        snap = server.metrics_snapshot()
        health = server.health()
        if metrics_path:
            server.export_metrics(metrics_path)
            say(f"\nmetrics JSON written to {metrics_path}")
        if trace_out:
            server.tracer.export(trace_out)
            say(f"Perfetto trace written to {trace_out} "
                "(load at https://ui.perfetto.dev)")
        if dump_dir:
            paths = server.dump_observability(dump_dir)
            say(f"observability dump: {', '.join(sorted(paths))}")
        if hold_s > 0:
            # keep serving /metrics after the demo work finishes so an
            # external scraper (a curl probe) can reach a live server
            say(f"holding {hold_s:.0f}s for metrics scrapes...")
            import time

            time.sleep(hold_s)
    say("\nmetrics snapshot:")
    say(json.dumps(snap, indent=2, sort_keys=True))
    say("\nhealth snapshot (as served while running):")
    say(json.dumps(health, indent=2, sort_keys=True))

    # -- self-checks (the acceptance criteria of the subsystem) -----------
    batch_sizes = factory.batch_sizes()
    coalesced = max(batch_sizes, default=0) >= 2
    cache = snap["cache"]
    distinct_buckets = len(set(factory.built))
    warm_only_first_use = cache["misses"] == distinct_buckets
    checks = {
        "coalesced (some batch >= 2 requests)": coalesced,
        "cache hit rate > 0 after warmup": cache["hits"] > 0,
        "cache misses only on first bucket use": warm_only_first_use,
        "all requests completed": snap["requests"].get("completed", 0)
        == len(futures),
        "health: scheduler alive, no open circuits, no degradations":
        health["scheduler_alive"] and health["status"] == "ok",
    }
    say("")
    ok = True
    for name, passed in checks.items():
        say(f"  [{'ok' if passed else 'FAIL'}] {name}")
        ok = ok and passed
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distrifuser_tpu_torch.serve",
        description="serve-subsystem demo (fake executors, CPU-only)",
    )
    ap.add_argument("--demo", action="store_true",
                    help="run the end-to-end scheduler demo")
    ap.add_argument("--metrics-path", type=str, default=None,
                    help="also write the metrics JSON artifact here")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus), /metrics.json and "
                         "/healthz on this port while the demo runs "
                         "(0 = ephemeral)")
    ap.add_argument("--hold-s", type=float, default=0.0,
                    help="keep the server (and its metrics endpoint) "
                         "alive this long after the demo work finishes, "
                         "so external scrapers can probe it")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="enable request-scoped tracing and write the "
                         "Perfetto-loadable trace JSON here")
    ap.add_argument("--dump-dir", type=str, default=None,
                    help="write the full observability dump (metrics/"
                         "registry/health/slo/trace) into this directory")
    args = ap.parse_args(argv)
    if not args.demo:
        ap.error("nothing to do: pass --demo (real serving is wired "
                 "through distrifuser_tpu_torch.serve.InferenceServer + "
                 "pipeline_executor_factory)")
    return run_demo(metrics_path=args.metrics_path,
                    metrics_port=args.metrics_port, hold_s=args.hold_s,
                    trace_out=args.trace_out, dump_dir=args.dump_dir)


if __name__ == "__main__":
    sys.exit(main())
