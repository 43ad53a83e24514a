"""CUDA graphs of the UNet step: each phase captured once, then replayed.

Counterpart of the JAX package's compiled step (``use_compiled_step``,
distrifuser_tpu/parallel/runner.py:625-638 and :1342-1372) and of the
reference's per-phase capture (pipelines.py:131-165).  The runner keeps
one ``StepGraph`` per UNet evaluation it runs, keyed by the evaluation's
phase ("sync", "stale", "shallow", "row", "col") and the shape of the
generation (batch, latent height, latent width):

* dense at one rank, the synchronous patch path (``full_sync``) and
  tensor parallelism: one graph;
* the displaced patch path: a sync graph and a stale graph;
* under the step cache, a "shallow" graph besides: the steady phase's
  body (stale, or sync where every step is synchronous) without the deep
  subtree, so the key is (phase, shallow);
* naive patch parallelism: a row graph and a column graph (``alternate``
  runs both).

Every graph of one shape reads the same ``StepInputs``: the UNet input
``x_in``, the timestep and the step index as device tensors, the text
embeddings, the added conditioning and the text KV.  The runner copies the
generation's values into them once per generation and ``x_in``, ``t`` and
the step before every replay, from device tensors: the partial refresh's
rotation ``step % k`` is computed and applied on the card
(``index_select`` / ``index_copy_``), so one graph serves every rotation.
The scheduler step and the CFG combine run outside the graph, as the
reference captures the UNet alone.

The stale (and shallow) phase reads the previous step's per-layer
buffers.  Eagerly a
stale step hands out new ``state_out`` tensors; under a graph those are
the graph's own outputs, rewritten by its next replay.  The stale graph
therefore reads a static ``state_in`` set, and after every replay its
``state_out`` is copied into it (one ``_foreach_copy_``; at SDXL CFG 2 x
sp 2 about 419 MB of bf16 a rank, under a millisecond of memory traffic on
an H100).  The first stale replay loads what the last sync replay wrote
the same way.  Two stale graphs ping-ponging between two buffer sets would
save that copy but need every refresh to land in a buffer given to it,
which the eager path does not do: the copy keeps the captured code the
eager code.

Before any capture every phase runs once eagerly, on a side stream, in
step order: that builds the kernels, runs their once-per-process
``cudaFuncSetAttribute``, and creates every NCCL communicator, the
point-to-point ones included (the halo pairs, the ring hops and the
batched flush alike).  A shallow step passes the buffers of the layers it
skips through unchanged: its outputs then are its own static inputs, which
the copy-back after a replay skips.  All graphs of a runner share one memory
pool.  A capture that fails raises and leaves no graph of that shape
behind, so the next generation captures again; a graph that was never
captured refuses to replay on the card; nothing retries eagerly.  The
kernel wrappers (``ops._build.LAUNCH_COUNTERS``) and the all-to-all
(parallel/collectives.py) count launches only while they run: each graph
records the launches it captured (the warm-up and the capture itself count
nothing: the capturing thread's launches go to a tally of their own,
``ops._build.launch_tally``, while other threads' keep counting) and adds
them at every replay, so a graphed call counts what an eager call counts.

On the CPU nothing is captured: a replay runs the same static-buffer step
eagerly and copies its results into the static outputs, so the CPU tests
exercise the buffers, the state hand-over and the aliasing of a replay.

``TickGraphs`` holds the PipeFusion runner's tick bodies
(parallel/pipefusion.py) the same way: one ``StepGraph`` each over its own
``TickInputs`` (the stage's input rows, the tick's step and chunk as device
scalars), for the warmup's mega-patch pass, the steady chunk pass and a
deep stage's pass-through; the bodies read and write the runner's
per-generation buffers in place, and the point-to-point hops between ticks
stay outside them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops._build import add_launches, launch_tally


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tensors, dict keys in
    sorted order (two trees built by one function pair up leaf by leaf)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [leaf for v in tree for leaf in _leaves(v)]


def _clone(tree):
    """A tree of new tensors with the shapes and values of ``tree``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def copy_tree(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place of
    ``dst`` (one multi-tensor launch); a tensor copied onto itself is
    skipped."""
    pairs = [(d, s) for d, s in zip(_leaves(dst), _leaves(src)) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _signature(tree) -> Tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(tree))


class StepInputs:
    """The static inputs of the graphs of one generation shape."""

    def __init__(self, x_in, t, enc, added, text_kv, step=0):
        self.x_in = x_in.clone()
        self.t = torch.as_tensor(t, device=x_in.device).clone()
        self.step = torch.as_tensor(step, device=x_in.device).clone()
        self.enc, self.added, self.text_kv = _clone(enc), _clone(added), _clone(text_kv)

    def matches(self, enc, added, text_kv) -> bool:
        """Do a generation's conditioning tensors fit these buffers?"""
        return (_signature(self.enc) == _signature(enc)
                and _signature(self.added) == _signature(added)
                and _signature(self.text_kv) == _signature(text_kv))

    def set_generation(self, enc, added, text_kv) -> None:
        copy_tree([self.enc, self.added, self.text_kv], [enc, added, text_kv])

    def set_step(self, x_in, t, step=0) -> None:
        self.x_in.copy_(x_in)
        self.t.copy_(t)
        self.step.copy_(step)


class StepGraph:
    """One UNet evaluation of one phase over static buffers.

    ``step_fn(phase, inputs, state_in)``, given to ``capture`` and
    ``replay``, is the eager evaluation, returning ``(out, state_out)``;
    the graph keeps no reference to it, so that dropping the runner frees
    its graphs (a graph holding NCCL work must be freed before its process
    group is destroyed).  A stateful graph (the stale phase) reads
    ``state_in``, which ``load_state`` fills; a stateless one is given
    None.  A graph captured over n ranks keeps the generation of the data
    groups it captured (``utils.config``) and refuses to replay once they
    were aborted or rebuilt: its collectives would run on communicators
    that are gone (serve/ranks.py)."""

    def __init__(self, phase: str, inputs: StepInputs, stateful: bool,
                 device: torch.device):
        self.phase = phase
        self.device = device
        self.inputs = inputs
        self.stateful = stateful
        self.state_in: Optional[Dict[str, torch.Tensor]] = None
        self.out: Optional[torch.Tensor] = None
        self.state_out = None
        self.graph = None
        self.generation: Optional[int] = None  # of the data groups captured over
        # launches of each kernel wrapper that launched during the capture,
        # and every count a replay adds (the log-sum-exp launches too)
        self.launches: Dict[Callable, int] = {}
        self.counts: Dict[Tuple[Callable, str], int] = {}

    def load_state(self, state) -> None:
        """Make ``state_in`` hold ``state`` (allocated at the first load)."""
        if state is self.state_in:
            return
        if self.state_in is None:
            self.state_in = {k: torch.empty_like(v) for k, v in state.items()}
        if set(state) != set(self.state_in):
            raise ValueError("the stale buffers do not match the captured layers")
        copy_tree(self.state_in, state)

    def run(self, step_fn: Callable):
        """The evaluation, eagerly, on the static buffers."""
        return step_fn(self.phase, self.inputs, self.state_in if self.stateful else None)

    def capture(self, step_fn: Callable, pool, stream: torch.cuda.Stream) -> None:
        """Record the evaluation into a CUDA graph on ``stream``; keeps the
        launches it captured (this thread's tally: ``launch_tally``) apart
        from the counters."""
        from ..utils.config import data_group_generation

        if dist.is_initialized() and dist.get_world_size() > 1:
            self.generation = data_group_generation()
        graph = torch.cuda.CUDAGraph()
        with launch_tally() as counts:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out, self.state_out = self.run(step_fn)
        self.counts = {key: n for key, n in counts.items() if n}
        self.launches = {fn: n for (fn, attr), n in self.counts.items()
                         if attr == "launches"}
        self.graph = graph

    def replay(self, step_fn: Callable):
        """Run the evaluation on the current inputs (on the CPU through
        ``step_fn``); returns ``(out, state)``, the state the next step
        reads (a stateful graph's own ``state_in`` after copying its
        refreshes in).  On the card a graph that was never captured
        raises."""
        if self.graph is not None:
            from ..utils.config import data_groups_live

            if self.generation is not None and not data_groups_live(self.generation):
                raise RuntimeError(
                    f"the {self.phase!r} step graph was captured over data groups that "
                    "were aborted or rebuilt since; build the pipeline anew")
            self.graph.replay()
            for (fn, attr), n in self.counts.items():
                add_launches(fn, n, attr)
        elif self.device.type == "cuda":
            raise RuntimeError(
                f"the {self.phase!r} step graph was never captured; a CUDA "
                "device replays captured graphs only")
        else:  # CPU: the same step, eagerly, into the static outputs
            out, state_out = self.run(step_fn)
            if self.out is None:
                self.out, self.state_out = out, state_out
            else:
                copy_tree([self.out, self.state_out], [out, state_out])
        if self.stateful:
            self.load_state(self.state_out)
            return self.out, self.state_in
        return self.out, self.state_out


class StepGraphs:
    """The graphs of one runner: one ``StepInputs`` and one ``StepGraph``
    per phase for the current generation shape, one memory pool.  A new
    shape or new conditioning shapes drop the old graphs and capture anew."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = None
        self.key = None
        self.inputs: Optional[StepInputs] = None
        self.graphs: Dict[str, StepGraph] = {}

    def clear(self) -> None:
        self.key, self.inputs, self.graphs = None, None, {}

    def begin(self, key, x_in, t, enc, added, text_kv,
              phases: Sequence[str], stateful: Sequence[str],
              step_fn: Callable, step=0) -> None:
        """Get the graphs of ``phases`` (in step order) ready for a
        generation of shape ``key`` and load its conditioning.
        ``step_fn(phase, inputs, state_in)`` is the eager evaluation; the
        phases in ``stateful`` read the state of the phase before them.
        The new graphs are kept only once all of them are captured: if a
        capture raises, the graphs of this shape are dropped."""
        if key != self.key or not self.inputs.matches(enc, added, text_kv):
            self.clear()
            self.key = key
            self.inputs = StepInputs(x_in, t, enc, added, text_kv, step)
        self.inputs.set_generation(enc, added, text_kv)
        graphs = dict(self.graphs)
        missing = [p for p in phases if p not in graphs]
        for phase in missing:
            graphs[phase] = StepGraph(phase, self.inputs, phase in stateful,
                                      self.device)
        if missing and self.device.type == "cuda":
            try:
                self._capture(graphs, phases, missing, step_fn)
            except BaseException:
                self.clear()
                raise
        self.graphs = graphs

    def _capture(self, graphs, phases, missing, step_fn) -> None:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        state = None
        # warm-up: every phase once, eagerly, in step order, uncounted
        with launch_tally(), torch.cuda.stream(side):
            for phase in phases:
                graph = graphs[phase]
                if graph.stateful:
                    graph.load_state(state)
                _, state = graph.run(step_fn)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for phase in missing:
            graphs[phase].capture(step_fn, self.pool, side)
        torch.cuda.synchronize(self.device)

    def __getitem__(self, phase: str) -> StepGraph:
        return self.graphs[phase]


class TickInputs:
    """The static inputs of one PipeFusion tick body: the stage's input
    rows ``h`` and the tick's step and chunk indices as device scalars,
    copied in from device tables before every replay."""

    def __init__(self, rows: torch.Tensor):
        self.h = torch.zeros_like(rows)
        self.step = torch.zeros((), dtype=torch.long, device=rows.device)
        self.chunk = torch.zeros((), dtype=torch.long, device=rows.device)

    def set_tick(self, h, step, chunk) -> None:
        self.h.copy_(h)
        self.step.copy_(step)
        self.chunk.copy_(chunk)


class TickGraphs(StepGraphs):
    """The tick bodies of the PipeFusion runner (parallel/pipefusion.py), one
    ``StepGraph`` each over its own ``TickInputs``: the warmup's mega-patch
    pass, the steady full tick and the deep stages' pass-through tick.  The
    bodies read and write the runner's per-generation buffers (the KV
    cache, the step cache's deltas, the residual coder's predictors), whose
    addresses ``key`` fixes: a new key drops the graphs.  Capture, pool and
    launch counts are ``StepGraphs``'s (the runner resets its buffers after
    the warm-up runs); on the CPU a replay runs the body eagerly."""

    def begin(self, key, rows: Dict[str, torch.Tensor], tick_fn: Callable) -> None:
        """Get a graph ready for each body of ``rows`` (kind -> a tensor
        shaped as its input rows) under ``key``; ``tick_fn(kind, inputs,
        None)`` is the eager body, returning ``(payload, None)``."""
        if key != self.key:
            self.clear()
            self.key = key
        graphs = dict(self.graphs)
        missing = [kind for kind in rows if kind not in graphs]
        for kind in missing:
            graphs[kind] = StepGraph(kind, TickInputs(rows[kind]), False, self.device)
        if missing and self.device.type == "cuda":
            try:
                self._capture(graphs, missing, missing, tick_fn)
            except BaseException:
                self.clear()
                raise
        self.graphs = graphs
