"""Serving over n ranks: rank 0's server drives the other ranks' executors.

The JAX package serves a pipeline that spans a mesh from one process: one
controller issues every device's program in host order.  The port runs one
process a rank, and a pipeline over n ranks issues collectives that every
rank must enter, in the same order on each communicator.  Here rank 0 runs
the whole `InferenceServer` (queue, batcher, executor cache, resilience
ladder, controller, tenancy, gateway, metrics) and the other ranks, the
*followers*, run only what rank 0 tells them to:

* **The control channel.** One gloo group over the world
  (``utils.config.control_group``) carries nothing but commands and their
  statuses; the data groups (NCCL on cards, gloo on the CPU or for ranks
  sharing one card) carry no command.  A command is an op, a sequence
  number, the executor's and the work's ids and small arguments (the
  `ExecKey` of a build, prompts, seeds, scalars, a step round's plan);
  messages are pickles sent point to point, each reply on tags of its
  command's own, so commands of several threads may be in flight at once.
* **What is a command.** Every executor operation that builds groups or
  graphs or issues a collective: a build (the factory, ``prepare``, the
  capture), an eviction, a whole-batch call, the three stages
  (``encode_stage``, ``denoise_stage``, ``decode_stage``) and the step
  contract (``step_begin``, ``step_run``, ``step_finish``, ``step_abort``,
  ``step_park``, ``step_resume``, ``step_export``, ``step_import``).  The
  rest stays on rank 0: the ladder decides there and its rebuilds are
  builds; previews, signatures and ``step_done`` read rank 0's carry
  (every rank holds the whole latent after a step).
* **Two phases.** A follower first runs its checks (its `FaultPlan` at
  the server's sites: ``"build"`` for a build, ``"execute"`` for a
  whole-batch call, a denoise stage and a step round; the executor and
  work it names) and reports ready or failed; only when every rank is
  ready does rank 0 say go, and every rank runs the operation.  So a rank
  that fails before a collective never leaves its peers waiting inside
  it.  After the operation every follower reports ok or failed (the
  error's type and text and whether it is an OOM) and rank 0 raises the
  first failure as the dispatch's own (`RankFailedError`, or the
  `ServeError` class the follower raised), so `failure_kind` and the
  degradation ladder act for the whole world: a follower's failure in the
  first phase (its fault plan, an executor or work it lacks), and one that
  every rank raises alike (an OOM at the same allocation of the same
  shapes), walks the ladder to a rebuild on every rank.
* **Order.** A follower runs each command on a *lane*, one thread a lane:
  ``main`` (builds, whole-batch calls, the step contract: what rank 0's
  scheduler thread issues), and one lane a stage (``encode``,
  ``denoise``, ``decode``: what rank 0's stage workers issue), each lane
  taking its commands in rank 0's order.  No two commands that issue
  collectives run at once: rank 0 holds one lock from such a command's
  post to its last status (builds, whole-batch calls, the step contract,
  denoise and decode stages; an encode issues none and overlaps them).
  Two communicators in flight at once can deadlock NCCL (its kernels
  wait on the device for their peers, and a CUDA call that synchronises
  the device on one rank then waits for another communicator's kernel
  that a peer never launches), so a decode of batch k-1 waits for the
  denoise of batch k, and the other way round.
* **Carries.** Each rank holds its own shard of each step work's carry,
  by work id, and parks and resumes it itself.  Rank 0 decides every
  step round (admission, fill, the EDF cohort, preemption) and sends the
  round's packing plan (`PipelineExecutor.step_plan`) with the works'
  ids; followers never recompute a packing.  ``step_export`` gathers
  every rank's carry leaves into one envelope (``rank_leaves`` in the
  header counts each rank's) and ``step_import`` hands each rank its own;
  the `ExecKey` carries the layout (``mesh_plan``), so a snapshot of
  another layout is refused typed before it reaches an executor.
* **Outputs.** Only rank 0 returns images; followers drop theirs after
  the decode.
* **A failure inside an operation** (queue 3 fault 9, repaired).  A rank
  that fails between two collectives of an operation, or hangs inside
  one, leaves its peers waiting in the next collective: a real
  `torch.cuda.OutOfMemoryError` on one rank alone in the middle of a
  denoise, a step or a decode is such a failure.  The data groups carry
  the generation of `utils.config` (``rebuild_data_groups``), so they can
  be given up and made anew:

  1. *Abort.*  The first failure after the go of a command with
     collectives -- rank 0's own, a follower's status, or rank 0's
     watchdog timing the command out (`RankLeader.abort`) -- aborts the
     data groups: rank 0 aborts its own and posts ``abort``, which each
     follower's dispatcher thread (not a lane) applies at once.  On NCCL
     every rank aborts its communicators (``_abort_process_group``), so a
     collective waiting on the card for a peer that left ends; gloo has
     no abort, and a rank waiting in a gloo collective leaves it through
     the group's timeout, which `utils.config.data_group_timeout` derives
     from the watchdog bound (so rank 0's watchdog may fire first: it
     then reads the failure that aborted the groups, `abort_cause`).
     Commands with collectives posted after the abort raise
     `RanksAbortedError` until the rebuild.
  2. *Abandon.*  A follower's dispatcher abandons each lane thread still
     inside a command with collectives, as the server's watchdog abandons
     its worker: it sends rank 0 the reports the command still owes
     (failed), the lane's own result is discarded when it ends, and a new
     lane thread takes the lane's next command.
  3. *Rebuild.*  Rank 0's command returns only when every rank has left
     it: rank 0's own operation ended and every follower reported (or was
     abandoned).  Its error is an out-of-memory if any rank reported one,
     else the first failure seen, so a follower's out-of-memory, not the
     timeout it caused on its peers, is what the ladder reads.  Before the next command the server drops every
     executor (their CUDA graphs hold the aborted communicators) and
     `RankLeader.rebuild` posts ``rebuild``: every rank drops its
     executors and makes the data groups of the next generation, in one
     order; the control group is never aborted nor rebuilt.  A command
     still in flight -- a rank 0 operation that has not left, a hang the
     abort cannot end -- holds the rebuild back, and the server sheds with
     `WatchdogTimeoutError` after another watchdog bound, as the JAX
     package's watchdog sheds behind an abandoned worker that still runs.
  4. *Ladder.*  The error then walks the ladder as on one card: an OOM
     to ``weight_quant_on`` built on every rank, a watchdog timeout or an
     execute failure against the retry budget and the breaker.  Step
     works that did not fail keep their carries (resident or parked) and
     move to the rebuilt executor of their key.

  Works stay with their rank across a rebuild; executors do not.  A hang
  that never ends (a kernel that never returns, a rank that is gone) keeps
  its command in flight, so every later command sheds after the bound
  until it ends; the server itself never stops for it.

`serve_over_ranks` is the launcher every rank calls with its own local
executor factory: rank 0 gets the server, followers run the loop until
rank 0's server stops.  `current_command` names the command a thread is
running (the collective fake of serve/testing.py checks the order with
it).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import pickle
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils import sync
from . import errors as errors_mod
from .errors import (
    DegradationInapplicableError,
    MigrationRejectedError,
    RetryableError,
    ServeError,
    ServerClosedError,
    WatchdogTimeoutError,
    is_oom,
)

# the op of each command, in the order of their codes (the collective
# fake all-reduces the code beside the sequence number)
OPS = ("build", "evict", "call", "encode", "denoise", "decode", "step_begin",
       "step_run", "step_finish", "step_abort", "step_park", "step_resume",
       "step_export", "step_import", "drop", "stop", "abort", "rebuild")
# where a follower runs each op; None: its dispatcher applies it at once
# (one-way commands: nothing collective, nothing to report)
LANES = {"build": "main", "call": "main", "encode": "encode", "denoise": "denoise",
         "decode": "decode", "evict": None, "drop": None, "stop": None,
         "abort": None, "rebuild": None,
         **{op: "main" for op in OPS if op.startswith("step_")}}
# the lanes whose commands issue collectives: rank 0 runs one at a time
# (module docstring)
COLLECTIVE_LANES = ("main", "denoise", "decode")
# the server's fault site a follower checks before each op
FAULT_SITES = {"build": "build", "call": "execute", "denoise": "execute",
               "step_run": "execute"}
# the executor methods the rank-0 proxy turns into commands (besides
# ``__call__``), where the local executor has them
STAGE_AND_STEP = ("encode_stage", "denoise_stage", "decode_stage", "step_begin",
                  "step_run", "step_finish", "step_abort", "step_park",
                  "step_resume", "step_export", "step_import")
WORK_ID = "rank_work_id"  # the key of a work dict's id on rank 0

_CMD_TAG = 1
_READY, _GO, _DONE = 0, 1, 2
_SEQ = itertools.count(1)  # one counter a process: tags never repeat
_CURRENT = threading.local()


def _tag(seq: int, phase: int) -> int:
    """The point-to-point tag of one phase of command ``seq``: below 2**31."""
    return 16 + 4 * (seq % (1 << 28)) + phase


def _send(obj: Any, dst: int, tag: int, group) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    dist.send(torch.tensor([len(data)], dtype=torch.int64), dst, group=group, tag=tag)
    dist.send(torch.frombuffer(bytearray(data), dtype=torch.uint8), dst, group=group,
              tag=tag)


def _recv(src: int, tag: int, group) -> Any:
    n = torch.zeros(1, dtype=torch.int64)
    dist.recv(n, src, group=group, tag=tag)
    buf = torch.empty(int(n), dtype=torch.uint8)
    dist.recv(buf, src, group=group, tag=tag)
    return pickle.loads(buf.numpy().tobytes())


def _current_card() -> Optional[int]:
    """The calling thread's current CUDA device (None without one): the
    card a rank's other threads must make current too, since a new thread
    starts on device 0."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_device()
    return None


def _on_card(card: Optional[int]):
    return torch.cuda.device(card) if card is not None else contextlib.nullcontext()


def current_command() -> Optional[Tuple[int, str]]:
    """``(sequence number, op)`` of the command this thread runs, on any
    rank, or None outside one."""
    return getattr(_CURRENT, "cmd", None)


@contextlib.contextmanager
def _running(seq: int, op: str):
    prev = current_command()
    _CURRENT.cmd = (seq, op)
    try:
        yield
    finally:
        _CURRENT.cmd = prev


class RankFailedError(RuntimeError):
    """A follower's failure as rank 0 raises it: the follower's rank, the
    error's type name and text, and ``oom`` (`errors.is_oom` reads it),
    so the ladder classifies it as it would the same error on rank 0."""

    def __init__(self, rank: int, type_name: str, text: str, oom: bool):
        super().__init__(f"rank {rank} failed: {type_name}: {text}")
        self.rank = rank
        self.type_name = type_name
        self.oom = bool(oom)


class RanksAbortedError(RetryableError):
    """A command over the ranks that could not run because the data groups
    were aborted after a failure inside an operation (module docstring):
    refused before its go until the rebuild, or a follower's lane that was
    abandoned.  Retryable: the retry runs after the rebuild."""


def _status(exc: BaseException) -> Dict[str, Any]:
    return {"ok": False, "type": type(exc).__name__, "text": str(exc),
            "oom": is_oom(exc), "rung": getattr(exc, "rung", None)}


def _rebuild(rank: int, st: Dict[str, Any]) -> Exception:
    """The exception rank 0 raises for follower ``rank``'s status."""
    text = f"rank {rank}: {st['text']}"
    if st["type"] == RanksAbortedError.__name__:
        return RanksAbortedError(text)
    if st.get("rung") is not None:
        return DegradationInapplicableError(text, rung=st["rung"])
    cls = getattr(errors_mod, st["type"], None)
    if isinstance(cls, type) and issubclass(cls, ServeError):
        return cls(text)
    return RankFailedError(rank, st["type"], st["text"], st["oom"])


class RankLeader:
    """Rank 0's end of the control channel (module docstring)."""

    def __init__(self, group, world: int):
        self.group = group
        self.world = world
        self.followers = list(range(1, world))
        self._send_lock = sync.Lock()
        self._collective_lock = sync.Lock()
        self._abort_lock = sync.Lock()
        self._xids = itertools.count(1)
        self._wids = itertools.count(1)
        self.closed: Optional[str] = None
        # why the data groups were aborted (None: they serve); cleared by
        # the rebuild
        self.aborted: Optional[str] = None
        self.commands = 0  # observability: two-phase commands posted
        self.aborts = self.rebuilds = 0
        # time.monotonic() of the last abort, and why
        self.last_abort_t: Optional[float] = None
        self.last_abort_reason: Optional[str] = None
        # the rank's failure that aborted the data groups (an out-of-memory
        # if one was seen), until the rebuild: what a watchdog timeout of
        # the command reads
        self.abort_cause: Optional[BaseException] = None
        # builds run on the server's scheduler thread: on this rank's card
        self._card = _current_card()

    def new_work_id(self) -> int:
        return next(self._wids)

    def _post_locked(self, msg: Dict[str, Any], per_rank=None) -> None:
        for r in self.followers:
            out = msg
            if per_rank is not None:
                out = dict(msg, args={**msg["args"], **per_rank[r]})
            _send(out, r, _CMD_TAG, self.group)

    def post(self, op: str, *, xid: Optional[int] = None,
             wid: Optional[int] = None) -> None:
        """A one-way command (``evict``, ``drop``, ``abort``): no reply,
        nothing collective; dropped silently once the channel is closed."""
        with self._send_lock:
            if self.closed is None:
                self._post_locked({"seq": next(_SEQ), "op": op, "xid": xid, "wid": wid,
                                   "args": {}})

    def close(self, reason: str = "server stopped") -> None:
        """Tell every follower to stop (idempotent); later commands raise
        `ServerClosedError` naming ``reason``."""
        with self._send_lock:
            if self.closed is not None:
                return
            self.closed = reason
            self._post_locked({"seq": next(_SEQ), "op": "stop", "xid": None, "wid": None,
                               "args": {}})

    def abort(self, reason: str, cause: Optional[BaseException] = None) -> bool:
        """Abort the data groups on every rank (module docstring, step 1):
        the followers' by their dispatchers, told first, then this rank's.
        ``cause`` is the rank's failure behind it, kept as `abort_cause`
        (an out-of-memory wins over any other).  Idempotent until the
        rebuild; returns whether this call aborted."""
        from ..utils.config import abort_data_groups

        with self._abort_lock:
            if cause is not None and (self.abort_cause is None or (
                    is_oom(cause) and not is_oom(self.abort_cause))):
                self.abort_cause = cause
            if self.aborted is not None:
                return False
            self.aborted = reason
            self.aborts += 1
            self.last_abort_t = time.monotonic()
            self.last_abort_reason = reason
        self.post("abort")
        abort_data_groups()
        return True

    def rebuild(self, timeout_s: float) -> int:
        """Make the data groups of the next generation on every rank
        (module docstring, step 3), once no command with collectives is in
        flight: waits up to ``timeout_s`` (<= 0: without bound) for the
        aborted command to end, else raises `WatchdogTimeoutError`.  The
        caller has dropped its executors.  Returns the new generation."""
        from ..utils.config import rebuild_data_groups

        if not self._collective_lock.acquire(timeout=timeout_s if timeout_s > 0 else -1):
            raise WatchdogTimeoutError(
                f"the aborted operation over {self.world} ranks still runs after a further "
                f"{timeout_s:.3f}s; shedding this dispatch")
        try:
            with self._send_lock:
                if self.closed is not None:
                    raise ServerClosedError(
                        f"the ranks' control channel is closed ({self.closed})")
                self._post_locked({"seq": next(_SEQ), "op": "rebuild", "xid": None,
                                   "wid": None, "args": {}})
            with _on_card(self._card):
                generation = rebuild_data_groups()
            with self._abort_lock:
                self.aborted = self.abort_cause = None
                self.rebuilds += 1
            return generation
        finally:
            self._collective_lock.release()

    def _refuse_if_aborted(self, collective: bool) -> None:
        if collective and self.aborted is not None:
            raise RanksAbortedError(
                f"the data groups over {self.world} ranks were aborted "
                f"({self.aborted}); the next dispatch rebuilds them")

    def command(self, op: str, run: Callable[[], Any], *, xid: Optional[int] = None,
                wid: Optional[int] = None, args: Optional[Dict[str, Any]] = None,
                per_rank: Optional[Dict[int, Dict[str, Any]]] = None):
        """Run ``op`` on every rank: post it, wait for every follower's
        ready, say go, run ``run`` here, collect every follower's status.
        Returns ``(rank 0's value, [each follower's result])``; raises an
        out-of-memory if any rank reported one, else the first failure seen,
        rank 0's or a follower's.  A failure after the
        go of a command with collectives aborts the data groups at once,
        and the command returns only when every rank has left it."""
        collective = LANES[op] in COLLECTIVE_LANES
        self._refuse_if_aborted(collective)
        lock = self._collective_lock if collective else contextlib.nullcontext()
        with lock:
            with self._send_lock:
                if self.closed is not None:
                    raise ServerClosedError(
                        f"the ranks' control channel is closed ({self.closed})")
                self._refuse_if_aborted(collective)
                seq = next(_SEQ)
                self.commands += 1
                self._post_locked({"seq": seq, "op": op, "xid": xid, "wid": wid,
                                   "args": dict(args or {})}, per_rank)
            ready = [_recv(r, _tag(seq, _READY), self.group) for r in self.followers]
            failed = next(((r, st) for r, st in zip(self.followers, ready)
                           if not st["ok"]), None)
            go = failed is None and not (collective and self.aborted is not None)
            for r in self.followers:
                _send(go, r, _tag(seq, _GO), self.group)
            if failed is not None:
                raise _rebuild(*failed)
            self._refuse_if_aborted(collective)
            failures: list = []  # (rank, error) in the order seen
            noted = threading.Lock()

            def note(rank: int, exc: BaseException) -> None:
                with noted:
                    failures.append((rank, exc))
                if collective:
                    self.abort(f"rank {rank} failed inside {op} {seq}: "
                               f"{type(exc).__name__}: {exc}", cause=exc)

            done: Dict[int, Dict[str, Any]] = {}

            def collect(r: int) -> None:
                st = _recv(r, _tag(seq, _DONE), self.group)
                done[r] = st
                if not st["ok"]:
                    note(r, _rebuild(r, st))

            # one receiver a follower: a failure is seen as soon as it is
            # reported, whichever follower's status comes first
            collectors = [sync.Thread(target=collect, args=(r,), daemon=True,
                                      name=f"serve-rank-status-{r}")
                          for r in self.followers]
            for t in collectors:
                t.start()
            value = None
            with _running(seq, op):
                try:
                    value = run()
                except BaseException as exc:  # noqa: BLE001 -- raised below
                    note(0, exc)
            for t in collectors:
                t.join()
            if failures:
                # an out-of-memory causes the failures it leaves on its
                # peers (a gloo timeout), whichever was seen first
                raise next((exc for _, exc in failures if is_oom(exc)), failures[0][1])
            return value, [done[r].get("result") for r in self.followers]

    def factory(self, local_factory: Callable[[Any], Any]) -> Callable[[Any], Any]:
        """The executor factory of rank 0's server: each build is a
        command (every rank runs its own ``local_factory(key)``), and the
        executor rank 0 serves with is a `RankedExecutor` over its own."""

        def build(key):
            xid = next(self._xids)

            def run():
                with _on_card(self._card):
                    return local_factory(key)

            try:
                local, _ = self.command("build", run, xid=xid, args={"key": key})
            except BaseException:
                # the ranks that did build drop theirs
                self.post("evict", xid=xid)
                raise
            return RankedExecutor(self, local, key, xid)

        return build


class RankedExecutor:
    """Rank 0's executor over n ranks: its own executor (``local``) whose
    every collective operation runs as a command on every rank.  Anything
    else (``batch_size``, ``step_signature``, ``step_done``,
    ``step_preview``, ``step_pack_stats``, ...) is rank 0's own.  Stage and
    step methods exist where the local executor has them, as the server's
    ``hasattr`` routing expects."""

    def __init__(self, leader: RankLeader, local, key, xid: int):
        self._leader = leader
        self._local = local
        self._xid = xid
        # ids of the works the followers still hold -> their batch size
        self._live: Dict[int, Optional[int]] = {}
        self.key = key
        self.world_size = leader.world
        for name in STAGE_AND_STEP:
            if hasattr(local, name):
                setattr(self, name, getattr(self, "_" + name))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._local, name)

    def _command(self, op, run, work=None, wid=None, **kw):
        """``op`` on every rank over this executor (and ``work``'s id)."""
        if wid is None and work is not None:
            wid = work[WORK_ID]
        return self._leader.command(op, run, xid=self._xid, wid=wid, **kw)

    def _new_work(self, op, run, batch_size=None, **kw):
        wid = self._leader.new_work_id()
        try:
            work, _ = self._command(op, run, wid=wid, **kw)
        except BaseException:
            # the followers that did create the work drop it
            self._leader.post("drop", wid=wid)
            raise
        work[WORK_ID] = wid
        self._live[wid] = batch_size
        return work

    # -- the server's release hooks -----------------------------------------

    def evict_on_followers(self) -> None:
        """The executor left rank 0's cache: the followers drop theirs."""
        self._leader.post("evict", xid=self._xid)

    def drop_work_on_followers(self, work) -> None:
        """A staged batch left the pipeline: followers still holding its
        work (a failed or cancelled batch) drop it."""
        wid = work.get(WORK_ID) if isinstance(work, dict) else None
        if wid in self._live:
            del self._live[wid]
            self._leader.post("drop", wid=wid)

    # -- whole-batch --------------------------------------------------------

    def __call__(self, prompts, negative_prompts, guidance_scale, seeds):
        local = self._local
        value, _ = self._command(
            "call", lambda: local(prompts, negative_prompts, guidance_scale, seeds),
            args={"prompts": list(prompts), "negative_prompts": list(negative_prompts),
                  "guidance_scale": float(guidance_scale),
                  "seeds": [int(s) for s in seeds]})
        return value

    # -- staged -------------------------------------------------------------

    def _encode_stage(self, prompts, negative_prompts, seeds):
        local = self._local
        return self._new_work(
            "encode", lambda: local.encode_stage(prompts, negative_prompts, seeds),
            batch_size=len(prompts),
            args={"prompts": list(prompts), "negative_prompts": list(negative_prompts),
                  "seeds": [int(s) for s in seeds]})

    def _denoise_stage(self, work, guidance_scale):
        wid = work[WORK_ID]
        out, _ = self._command(
            "denoise", lambda: self._local.denoise_stage(work, guidance_scale), work,
            args={"guidance_scale": float(guidance_scale),
                  "batch_size": self._live.get(wid)})
        out[WORK_ID] = wid
        return out

    def _decode_stage(self, work):
        images, _ = self._command("decode", lambda: self._local.decode_stage(work), work)
        self._live.pop(work[WORK_ID], None)
        return images

    # -- step-granular ------------------------------------------------------

    def _step_begin(self, prompt, negative_prompt, seed, guidance_scale):
        args = {"prompt": prompt, "negative_prompt": negative_prompt, "seed": int(seed),
                "guidance_scale": float(guidance_scale)}
        return self._new_work(
            "step_begin",
            lambda: self._local.step_begin(prompt, negative_prompt, seed, guidance_scale),
            args=args)

    def _step_run(self, works):
        local = self._local
        plan_fn = getattr(local, "step_plan", None)
        plan = plan_fn(works) if plan_fn is not None else None

        def run():
            return local.step_run(works) if plan is None else local.step_run(works, plan)

        self._command("step_run", run, args={"wids": [w[WORK_ID] for w in works],
                                             "plan": plan})

    def _step_finish(self, work):
        image, _ = self._command("step_finish", lambda: self._local.step_finish(work), work)
        self._live.pop(work[WORK_ID], None)
        return image

    def _step_abort(self, work):
        wid = work[WORK_ID]
        try:
            self._command("step_abort", lambda: self._local.step_abort(work), work)
        except BaseException:
            # (data groups aborted, an executor dropped by a rebuild) the
            # work is released here and dropped on the followers
            self._local.step_abort(work)
            self._leader.post("drop", wid=wid)
            raise
        finally:
            self._live.pop(wid, None)

    def _step_park(self, work):
        self._command("step_park", lambda: self._local.step_park(work), work)

    def _step_resume(self, work):
        self._command("step_resume", lambda: self._local.step_resume(work), work)

    def _step_export(self, work):
        """Every rank's carry leaves in one envelope: rank 0's first, then
        each follower's; ``rank_leaves`` counts them."""
        (extra, leaves), others = self._command(
            "step_export", lambda: self._local.step_export(work), work)
        extra = dict(extra)
        extra["rank_leaves"] = [len(leaves)] + [len(o) for o in others]
        return extra, list(leaves) + [leaf for o in others for leaf in o]

    def _step_import(self, meta, leaves, prompt, negative_prompt, seed, guidance_scale):
        counts = meta.get("rank_leaves")
        plan = self.key.mesh_plan if self.key is not None else "?"
        if (not isinstance(counts, list) or len(counts) != self._leader.world
                or sum(counts) != len(leaves)):
            raise MigrationRejectedError(
                f"carry snapshot holds the leaves of "
                f"{len(counts) if isinstance(counts, list) else 1} rank(s); this "
                f"executor runs on {self._leader.world} ranks ({plan})")
        parts, at = [], 0
        for n in counts:
            parts.append(list(leaves[at:at + n]))
            at += n
        local_meta = {k: v for k, v in meta.items() if k != "rank_leaves"}
        args = {"meta": local_meta, "prompt": prompt, "negative_prompt": negative_prompt,
                "seed": int(seed), "guidance_scale": float(guidance_scale)}
        per_rank = {r: {"leaves": parts[r]} for r in self._leader.followers}
        return self._new_work(
            "step_import",
            lambda: self._local.step_import(local_meta, parts[0], prompt, negative_prompt,
                                            seed, guidance_scale),
            args=args, per_rank=per_rank)


_STOP = object()
_LANE_JOIN_S = 60.0  # how long a stopping follower waits for each lane's thread


class _InFlight:
    """One command on a follower's lane, from its post to its last
    report: ``owes`` is the report rank 0 still waits for ("ready", "go"
    -- the lane waits for rank 0's go --, "done" or None).  Whoever takes
    a report under ``lock`` sends it: the lane, or the dispatcher when it
    abandons the lane (`RankFollower._abandon`)."""

    def __init__(self, cmd: Dict[str, Any]):
        self.cmd = cmd
        self.owes: Optional[str] = "ready"
        self.abandoned = False
        self.lock = threading.Lock()

    def take(self, owed: str, then: Optional[str]) -> bool:
        """The lane's turn to send the ``owed`` report: False (send
        nothing) once the dispatcher abandoned the command."""
        with self.lock:
            if self.abandoned:
                return False
            assert self.owes == owed, (self.owes, owed)
            self.owes = then
            return True


def _abandoned_status(rank: int) -> Dict[str, Any]:
    return {"ok": False, "type": RanksAbortedError.__name__, "oom": False, "rung": None,
            "text": f"rank {rank} abandoned its lane: the data groups were aborted"}


class RankFollower:
    """A follower's end: the dispatcher loop on the calling thread and one
    thread a lane (module docstring).  ``executor_factory(key)`` builds
    this rank's executor for a key; ``fault_plan`` is consulted at the
    server's sites; ``prompt_cache_capacity`` gives this rank's executors
    a prompt cache as rank 0's server gives its own."""

    def __init__(self, group, executor_factory: Callable[[Any], Any], *,
                 fault_plan=None, prompt_cache_capacity: int = 0):
        self.group = group
        self.rank = dist.get_rank()
        self.executor_factory = executor_factory
        self.fault_plan = fault_plan
        self.prompt_cache = None
        if prompt_cache_capacity > 0:
            from .promptcache import PromptCache

            self.prompt_cache = PromptCache(prompt_cache_capacity)
        self._lock = sync.Lock()
        self._executors: Dict[int, Tuple[Any, Any]] = {}  # xid -> (key, executor)
        self._works: Dict[int, Any] = {}  # wid -> this rank's work
        self._inflight: Dict[int, _InFlight] = {}  # seq -> its command, until reported
        # executors released (an ``evict``, or a rebuild) and works
        # dropped so far
        self.evicted = self.dropped = 0
        self.aborts = self.rebuilds = self.abandoned = 0
        self._aborting = None  # the thread aborting this generation's groups
        self._card = _current_card()  # the lanes' card: the caller's

    def run(self) -> None:
        """Serve rank 0's commands until it stops the server."""
        lanes: Dict[str, Tuple[Any, Any]] = {}
        try:
            while True:
                cmd = _recv(0, _CMD_TAG, self.group)
                op = cmd["op"]
                if op == "stop":
                    return
                if op == "evict":
                    with self._lock:
                        self.evicted += self._executors.pop(cmd["xid"], None) is not None
                    continue
                if op == "drop":
                    with self._lock:
                        self.dropped += self._works.pop(cmd["wid"], None) is not None
                    continue
                if op == "abort":
                    self._abort(lanes)
                    continue
                if op == "rebuild":
                    self._rebuild()
                    continue
                lane = LANES[op]
                if lane not in lanes:
                    lanes[lane] = self._new_lane(lane)
                item = _InFlight(cmd)
                with self._lock:
                    self._inflight[cmd["seq"]] = item
                lanes[lane][0].put(item)
        finally:
            for q, _ in lanes.values():
                q.put(_STOP)
            for _, t in lanes.values():
                t.join(_LANE_JOIN_S)
            with self._lock:
                self._works.clear()
                self._executors.clear()

    def _new_lane(self, lane: str):
        q = sync.Queue()
        t = sync.Thread(target=self._lane, args=(q,), name=f"serve-rank{self.rank}-{lane}",
                        daemon=True)
        t.start()
        return q, t

    def _abort(self, lanes) -> None:
        """Rank 0's ``abort`` (module docstring, steps 1-2): abort this
        rank's data groups, then abandon every command with collectives
        still in flight, each lane that held one replaced by a new thread."""
        from ..utils.config import abort_data_groups

        self.aborts += 1
        # on its own thread: the dispatcher reports for the stuck lanes now
        self._aborting = sync.Thread(target=abort_data_groups, daemon=True,
                                     name=f"serve-rank{self.rank}-abort")
        self._aborting.start()
        with self._lock:
            stuck = [item for item in self._inflight.values()
                     if LANES[item.cmd["op"]] in COLLECTIVE_LANES]
        for lane in {LANES[item.cmd["op"]] for item in stuck}:
            if lane in lanes:
                old_q, _ = lanes[lane]
                old_q.put(_STOP)  # the old thread ends after its command
                lanes[lane] = self._new_lane(lane)
        for item in stuck:
            self._abandon(item)

    def _abandon(self, item: _InFlight) -> None:
        """Send rank 0 what ``item``'s command still owes, as failed; the
        lane's own reports and result are discarded.  A lane waiting for
        rank 0's go receives it itself (and reports, failed, if it is a
        go)."""
        seq = item.cmd["seq"]
        with item.lock:
            owes = item.owes
            if item.abandoned or owes is None:
                return
            item.abandoned = True
            if owes != "go":
                item.owes = None
        self.abandoned += 1
        if owes == "go":  # the lane's receive is posted: it reports itself
            return
        self._forget(seq)
        if owes == "ready":
            _send(_abandoned_status(self.rank), 0, _tag(seq, _READY), self.group)
            _recv(0, _tag(seq, _GO), self.group)  # a failed ready: never a go
        else:
            _send(_abandoned_status(self.rank), 0, _tag(seq, _DONE), self.group)

    def _rebuild(self) -> None:
        """Rank 0's ``rebuild`` (module docstring, step 3): drop every
        executor (their graphs hold the aborted communicators), then make
        the next generation of data groups, at the point of the order of
        groups rank 0 makes them.  Works stay."""
        from ..utils.config import rebuild_data_groups

        if self._aborting is not None:  # this generation's aborts first
            self._aborting.join(_LANE_JOIN_S)
            self._aborting = None
        with self._lock:
            self.evicted += len(self._executors)
            self._executors.clear()
        gc.collect()
        with _on_card(self._card):
            if self._card is not None:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            rebuild_data_groups()
        self.rebuilds += 1

    def _lane(self, q) -> None:
        if self._card is not None:
            torch.cuda.set_device(self._card)
        while True:
            item = q.get()
            if item is _STOP:
                return
            self._execute(item)

    def _execute(self, item: _InFlight) -> None:
        cmd = item.cmd
        seq, op = cmd["seq"], cmd["op"]
        if item.abandoned:
            return
        try:
            fn = self._prepare(cmd)
            ready: Dict[str, Any] = {"ok": True}
        except BaseException as exc:  # noqa: BLE001 -- reported to rank 0
            fn, ready = None, _status(exc)
        if not item.take("ready", "go"):
            return
        _send(ready, 0, _tag(seq, _READY), self.group)
        go = _recv(0, _tag(seq, _GO), self.group)
        with item.lock:
            abandoned = item.abandoned
            item.owes = "done" if go and not abandoned else None
        if not go or abandoned:
            self._forget(seq)
            if go:  # abandoned while it waited for the go: report, do not run
                _send(_abandoned_status(self.rank), 0, _tag(seq, _DONE), self.group)
            return
        with _running(seq, op):
            try:
                done = {"ok": True, "result": fn()}
            except BaseException as exc:  # noqa: BLE001 -- reported to rank 0
                done = _status(exc)
        if not item.take("done", None):
            return
        self._forget(seq)
        _send(done, 0, _tag(seq, _DONE), self.group)

    def _forget(self, seq: int) -> None:
        with self._lock:
            self._inflight.pop(seq, None)

    def _executor(self, xid):
        with self._lock:
            return self._executors[xid]

    def _work(self, wid, pop=False):
        with self._lock:
            return self._works.pop(wid) if pop else self._works[wid]

    def _keep(self, wid, work) -> None:
        with self._lock:
            self._works[wid] = work

    def _prepare(self, cmd: Dict[str, Any]) -> Callable[[], Any]:
        """The checks of the first phase; returns the operation."""
        op, a, xid, wid = cmd["op"], cmd["args"], cmd["xid"], cmd["wid"]
        site = FAULT_SITES.get(op)
        if op == "build":
            key = a["key"]
            if self.fault_plan is not None:
                self.fault_plan.check(site, key=key)

            def build():
                ex = self.executor_factory(key)
                if self.prompt_cache is not None and hasattr(ex, "attach_prompt_cache"):
                    ex.attach_prompt_cache(self.prompt_cache)
                with self._lock:
                    self._executors[xid] = (key, ex)

            return build
        key, ex = self._executor(xid)
        if site is not None and self.fault_plan is not None:
            n = (len(a["prompts"]) if "prompts" in a else
                 len(a["wids"]) if "wids" in a else a.get("batch_size"))
            self.fault_plan.check(site, key=key, batch_size=n)
        if op == "call":  # the images stay here: rank 0 returns its own
            return _dropping(ex, a["prompts"], a["negative_prompts"], a["guidance_scale"],
                             a["seeds"])
        if op == "encode":
            return lambda: self._keep(wid, ex.encode_stage(
                a["prompts"], a["negative_prompts"], a["seeds"]))
        if op == "step_begin":
            return lambda: self._keep(wid, ex.step_begin(
                a["prompt"], a["negative_prompt"], a["seed"], a["guidance_scale"]))
        if op == "step_import":
            return lambda: self._keep(wid, ex.step_import(
                a["meta"], a["leaves"], a["prompt"], a["negative_prompt"], a["seed"],
                a["guidance_scale"]))
        if op == "step_run":
            works = [self._work(w) for w in a["wids"]]
            plan = [] if a["plan"] is None else [a["plan"]]
            return _dropping(ex.step_run, works, *plan)
        work = self._work(wid)
        if op == "denoise":
            return lambda: self._keep(wid, ex.denoise_stage(work, a["guidance_scale"]))
        if op in ("decode", "step_finish", "step_abort"):
            method = {"decode": "decode_stage", "step_finish": "step_finish",
                      "step_abort": "step_abort"}[op]

            def finish():
                self._work(wid, pop=True)
                getattr(ex, method)(work)

            return finish
        if op == "step_export":
            return lambda: list(ex.step_export(work)[1])
        return _dropping(getattr(ex, op), work)  # step_park / step_resume


def _dropping(fn, *args) -> Callable[[], None]:
    """``fn(*args)`` as a follower's operation whose result stays on the
    follower (it reports only ok)."""

    def run() -> None:
        fn(*args)

    return run


def serve_over_ranks(executor_factory: Callable[[Any], Any], config=None, *,
                     fault_plan=None, **server_kwargs):
    """The launcher every rank calls, after ``init_process_group``, with
    its own ``executor_factory`` (e.g. `pipeline_executor_factory` over a
    build function whose `DistriConfig` spans the world and is made anew
    at each build, so a rebuild's executors hold the new generation's
    groups) and the same ``config``: on rank 0 it returns an
    `InferenceServer` (not started) whose executors span the ranks, and
    whose ``stop()`` releases the followers; on every other rank it runs
    the follower loop until then and returns None.  Before either, every
    rank derives the data groups' timeout from the watchdog bound (and
    makes the existing data groups anew if it changed), and on the card
    builds every kernel library, so that no rank compiles a kernel while
    its peers wait in a collective.  ``fault_plan`` is this rank's (rank
    0's goes to its server); ``server_kwargs`` are rank 0's
    `InferenceServer` keywords (pass ``mesh_plan=distri_config.mesh_plan``).
    At world 1 it returns a plain server."""
    from ..utils.config import (ServeConfig, control_group, rebuild_data_groups,
                                set_data_group_watchdog)
    from .server import InferenceServer

    config = config or ServeConfig()
    group = control_group()
    if group is None:
        return InferenceServer(executor_factory, config, fault_plan=fault_plan,
                               **server_kwargs)
    if torch.cuda.is_available():
        from ..ops._build import build_all

        build_all()
    if set_data_group_watchdog(config.resilience.watchdog_timeout_s):
        rebuild_data_groups()
    world, rank = dist.get_world_size(), dist.get_rank()
    if rank == 0:
        leader = RankLeader(group, world)
        return InferenceServer(leader.factory(executor_factory), config,
                               fault_plan=fault_plan, ranks=leader, **server_kwargs)
    RankFollower(group, executor_factory, fault_plan=fault_plan,
                 prompt_cache_capacity=config.prompt_cache_capacity).run()
    return None
