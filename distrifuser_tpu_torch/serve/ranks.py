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
* **Failures the protocol cannot bound.** A rank that hangs inside a
  collective, or fails inside an operation between two of its
  collectives, leaves its peers waiting in the next one: a real
  `torch.cuda.OutOfMemoryError` on one rank alone in the middle of a
  denoise, a step or a decode is such a failure, and it never reaches the
  ladder.  Rank 0's watchdog cannot abandon such a call (unlike the JAX
  package's, whose abandoned program holds no peer), so over n ranks a
  watchdog timeout is fatal to the server: `InferenceServer.health` says
  so, the followers are told to stop, and every later command raises
  `ServerClosedError`.

`serve_over_ranks` is the launcher every rank calls with its own local
executor factory: rank 0 gets the server, followers run the loop until
rank 0's server stops.  `current_command` names the command a thread is
running (the collective fake of serve/testing.py checks the order with
it).
"""

from __future__ import annotations

import contextlib
import itertools
import pickle
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils import sync
from . import errors as errors_mod
from .errors import (
    DegradationInapplicableError,
    MigrationRejectedError,
    ServeError,
    ServerClosedError,
    is_oom,
)

# the op of each command, in the order of their codes (the collective
# fake all-reduces the code beside the sequence number)
OPS = ("build", "evict", "call", "encode", "denoise", "decode", "step_begin",
       "step_run", "step_finish", "step_abort", "step_park", "step_resume",
       "step_export", "step_import", "drop", "stop")
# where a follower runs each op; None: its dispatcher applies it at once
# (one-way commands: nothing collective, nothing to report)
LANES = {"build": "main", "call": "main", "encode": "encode", "denoise": "denoise",
         "decode": "decode", "evict": None, "drop": None, "stop": None,
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


def _status(exc: BaseException) -> Dict[str, Any]:
    return {"ok": False, "type": type(exc).__name__, "text": str(exc),
            "oom": is_oom(exc), "rung": getattr(exc, "rung", None)}


def _rebuild(rank: int, st: Dict[str, Any]) -> Exception:
    """The exception rank 0 raises for follower ``rank``'s status."""
    text = f"rank {rank}: {st['text']}"
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
        self._xids = itertools.count(1)
        self._wids = itertools.count(1)
        self.closed: Optional[str] = None
        self.commands = 0  # observability: two-phase commands posted
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
        """A one-way command (``evict``, ``drop``): no reply, nothing
        collective; dropped silently once the channel is closed."""
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

    def command(self, op: str, run: Callable[[], Any], *, xid: Optional[int] = None,
                wid: Optional[int] = None, args: Optional[Dict[str, Any]] = None,
                per_rank: Optional[Dict[int, Dict[str, Any]]] = None):
        """Run ``op`` on every rank: post it, wait for every follower's
        ready, say go, run ``run`` here, collect every follower's status.
        Returns ``(rank 0's value, [each follower's result])``; raises rank
        0's own error, else the first follower's."""
        lock = (self._collective_lock if LANES[op] in COLLECTIVE_LANES
                else contextlib.nullcontext())
        with lock:
            with self._send_lock:
                if self.closed is not None:
                    raise ServerClosedError(
                        f"the ranks' control channel is closed ({self.closed})")
                seq = next(_SEQ)
                self.commands += 1
                self._post_locked({"seq": seq, "op": op, "xid": xid, "wid": wid,
                                   "args": dict(args or {})}, per_rank)
            ready = [_recv(r, _tag(seq, _READY), self.group) for r in self.followers]
            failed = next(((r, st) for r, st in zip(self.followers, ready)
                           if not st["ok"]), None)
            for r in self.followers:
                _send(failed is None, r, _tag(seq, _GO), self.group)
            if failed is not None:
                raise _rebuild(*failed)
            value, err = None, None
            with _running(seq, op):
                try:
                    value = run()
                except BaseException as exc:  # noqa: BLE001 -- raised below
                    err = exc
            done = [_recv(r, _tag(seq, _DONE), self.group) for r in self.followers]
            if err is not None:
                raise err
            failed = next(((r, st) for r, st in zip(self.followers, done)
                           if not st["ok"]), None)
            if failed is not None:
                raise _rebuild(*failed)
            return value, [st.get("result") for st in done]

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
        self._command("step_abort", lambda: self._local.step_abort(work), work)
        self._live.pop(work[WORK_ID], None)

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
        self.evicted = self.dropped = 0  # one-way releases applied
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
                lane = LANES[op]
                if lane not in lanes:
                    q = sync.Queue()
                    t = sync.Thread(target=self._lane, args=(q,),
                                    name=f"serve-rank{self.rank}-{lane}", daemon=True)
                    t.start()
                    lanes[lane] = (q, t)
                lanes[lane][0].put(cmd)
        finally:
            for q, _ in lanes.values():
                q.put(_STOP)
            for _, t in lanes.values():
                t.join(_LANE_JOIN_S)
            with self._lock:
                self._works.clear()
                self._executors.clear()

    def _lane(self, q) -> None:
        if self._card is not None:
            torch.cuda.set_device(self._card)
        while True:
            cmd = q.get()
            if cmd is _STOP:
                return
            self._execute(cmd)

    def _execute(self, cmd: Dict[str, Any]) -> None:
        seq, op = cmd["seq"], cmd["op"]
        try:
            fn = self._prepare(cmd)
            ready: Dict[str, Any] = {"ok": True}
        except BaseException as exc:  # noqa: BLE001 -- reported to rank 0
            fn, ready = None, _status(exc)
        _send(ready, 0, _tag(seq, _READY), self.group)
        if not _recv(0, _tag(seq, _GO), self.group):
            return
        with _running(seq, op):
            try:
                done = {"ok": True, "result": fn()}
            except BaseException as exc:  # noqa: BLE001 -- reported to rank 0
                done = _status(exc)
        _send(done, 0, _tag(seq, _DONE), self.group)

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
    build function whose `DistriConfig` spans the world): on rank 0 it
    returns an `InferenceServer` (not started) whose executors span the
    ranks, and whose ``stop()`` releases the followers; on every other
    rank it runs the follower loop until then and returns None.
    ``fault_plan`` is this rank's (rank 0's goes to its server);
    ``server_kwargs`` are rank 0's `InferenceServer` keywords (pass
    ``mesh_plan=distri_config.mesh_plan``).  At world 1 it returns a plain
    server."""
    from ..utils.config import ServeConfig, control_group
    from .server import InferenceServer

    config = config or ServeConfig()
    group = control_group()
    if group is None:
        return InferenceServer(executor_factory, config, fault_plan=fault_plan,
                               **server_kwargs)
    world, rank = dist.get_world_size(), dist.get_rank()
    if rank == 0:
        leader = RankLeader(group, world)
        return InferenceServer(leader.factory(executor_factory), config,
                               fault_plan=fault_plan, ranks=leader, **server_kwargs)
    RankFollower(group, executor_factory, fault_plan=fault_plan,
                 prompt_cache_capacity=config.prompt_cache_capacity).run()
    return None
