"""Continuous micro-batching: coalesce compatible requests into one
batched invocation.

Two requests are *compatible* — may share one compiled program dispatch —
when they agree on every field of `BatchKey`: model, scheduler family,
snapped resolution bucket, step count, and guidance mode.  Everything else
(prompt, seed, guidance scale within a mode) batches freely.

Shape bucketing is what makes the compiled-executable cache effective: a
fixed `BucketTable` maps each requested resolution to the smallest bucket
covering it, so the service compiles per *bucket*, not per requested size.
This is the serving analog of the repo's fixed-at-config-time height/width
(DistriConfig forbids per-call resolution: a new shape means new static
buffers and new captured CUDA graphs).

The batcher is *continuous*: it forms a batch as soon as work exists,
lingering at most ``batch_window_s`` for followers once the first request
of a batch is in hand — latency bounded by the window, throughput bounded
only by the mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

from .errors import DeadlineExceededError, NoBucketError  # noqa: F401
from .queue import Request, RequestQueue


class BucketTable:
    """Resolution -> bucket snapping over a fixed (height, width) table."""

    def __init__(self, buckets: Sequence[Sequence[int]]):
        if not buckets:
            raise ValueError("bucket table must not be empty")
        for h, w in buckets:
            if int(h) % 8 or int(w) % 8:
                # same constraint as DistriConfig.height/width
                raise ValueError(
                    f"bucket {(int(h), int(w))} must be multiples of 8"
                )
        # area-major, then lexicographic: the first covering entry found in
        # a front-to-back scan is the smallest covering bucket
        self.buckets: Tuple[Tuple[int, int], ...] = tuple(
            sorted(
                {(int(h), int(w)) for h, w in buckets},
                key=lambda hw: (hw[0] * hw[1], hw),
            )
        )

    def snap(self, height: int, width: int) -> Tuple[int, int]:
        """Smallest bucket with bucket_h >= height and bucket_w >= width."""
        for bh, bw in self.buckets:
            if bh >= height and bw >= width:
                return (bh, bw)
        raise NoBucketError(
            f"no bucket covers {height}x{width} "
            f"(largest: {self.buckets[-1][0]}x{self.buckets[-1][1]})"
        )


@dataclasses.dataclass(frozen=True)
class BatchKey:
    """Compatibility class of a request — and, joined with the mesh plan,
    the compiled-executable cache key (serve/cache.py).

    ``guidance_scale`` is a compatibility field but NOT a compile field:
    the scale is a runtime scalar shared by one invocation, so requests
    with different scales must not coalesce — yet every scale in the same
    *mode* (CFG on/off) runs the same program (`cfg` is what reaches
    `ExecKey`)."""

    model_id: str
    scheduler: str  # scheduler family name, e.g. "ddim" / "flow-euler"
    height: int  # bucket height
    width: int  # bucket width
    steps: int
    guidance_scale: float

    @property
    def cfg(self) -> bool:
        """Guidance mode: classifier-free guidance on/off."""
        return self.guidance_scale > 1.0


class MicroBatcher:
    """Forms one batch per call from a `RequestQueue` (single consumer).

    ``on_reject(request, exc)`` fires for every request dropped at
    scheduling time (expired deadline, unsatisfiable bucket) — the server
    uses it to fail the future and count the rejection.  Rejected requests
    are never returned in a batch.
    """

    def __init__(
        self,
        queue: RequestQueue,
        table: BucketTable,
        *,
        model_id: str,
        scheduler: str,
        max_batch_size: int,
        batch_window_s: float = 0.0,
        on_reject: Optional[Callable[[Request, Exception], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        batch_cap: Optional[Callable[[BatchKey], Optional[int]]] = None,
    ):
        assert max_batch_size >= 1, max_batch_size
        self.queue = queue
        self.table = table
        self.model_id = model_id
        self.scheduler = scheduler
        self.max_batch_size = max_batch_size
        self.batch_window_s = batch_window_s
        self.on_reject = on_reject or (lambda req, exc: None)
        self.clock = clock
        # batch_cap(key) -> Optional[int]: a dynamic per-key ceiling below
        # max_batch_size.  The resilience layer's split_batch degradation
        # uses it to make an OOM lesson sticky — once a bucket's coalesced
        # batch had to be halved, the batcher stops FORMING wider batches
        # for that key instead of re-discovering the OOM per dispatch.
        self.batch_cap = batch_cap

    def _cap_for(self, key: BatchKey) -> int:
        cap = self.max_batch_size
        if self.batch_cap is not None:
            c = self.batch_cap(key)
            if c is not None:
                cap = min(cap, max(1, int(c)))
        return cap

    def _key_of(self, req: Request) -> BatchKey:
        bh, bw = self.table.snap(req.height, req.width)
        return BatchKey(
            model_id=self.model_id,
            scheduler=self.scheduler,
            height=bh,
            width=bw,
            steps=req.num_inference_steps,
            guidance_scale=req.guidance_scale,
        )

    def _reap_expired(self) -> None:
        for req in self.queue.pop_expired(self.clock()):
            self.on_reject(
                req,
                DeadlineExceededError(
                    f"request {req.request_id} expired after "
                    f"{self.clock() - req.enqueue_ts:.3f}s in queue"
                ),
            )

    def _take_leader(self) -> Optional[Tuple[Request, BatchKey]]:
        """Pop the oldest live request and its key; reject unsnappable
        resolutions in place and keep scanning."""
        while True:
            head = self.queue.pop_where(lambda r: True, 1)
            if not head:
                return None
            req = head[0]
            try:
                key = self._key_of(req)
            except NoBucketError as exc:
                self.on_reject(req, exc)
                continue
            req.bucket = (key.height, key.width)
            req.dequeue_ts = self.clock()
            return req, key

    def next_batch(
        self, timeout: float
    ) -> Optional[Tuple[BatchKey, List[Request]]]:
        """One scheduling round: wait up to ``timeout`` for work, expire
        stale requests, pick the oldest live request as batch leader, then
        coalesce followers with the same `BatchKey` — first from the
        backlog, then by lingering ``batch_window_s`` for late arrivals
        while the batch has room."""
        if not self.queue.wait_nonempty(timeout):
            return None
        self._reap_expired()
        leader = self._take_leader()
        if leader is None:
            return None
        req, key = leader
        batch = [req]
        cap = self._cap_for(key)

        def take_followers() -> None:
            def compatible(r: Request) -> bool:
                try:
                    return self._key_of(r) == key
                except NoBucketError:
                    return False

            room = cap - len(batch)
            if room > 0:
                more = self.queue.pop_where(compatible, room)
                now = self.clock()
                for m in more:
                    m.bucket = (key.height, key.width)
                    m.dequeue_ts = now
                batch.extend(more)

        take_followers()
        if len(batch) < cap and self.batch_window_s > 0:
            deadline = self.clock() + self.batch_window_s
            seen = self.queue.seq
            while len(batch) < cap:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    break
                # sleep until an ARRIVAL, not mere non-emptiness: queued
                # incompatible requests must not turn the linger into a spin
                now = self.queue.wait_arrival(seen, remaining)
                if now == seen:
                    break  # window elapsed with no new arrivals
                seen = now
                take_followers()
        return key, batch
