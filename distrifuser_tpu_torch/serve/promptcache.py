"""Prompt/embedding LRU cache in front of the text-encode stage.

Production image-generation traffic repeats prompts heavily (retries,
variations over seeds, shared templates), and the text encoders run the
same tokens to the same embeddings every time -- so the encode stage is
the one pipeline stage whose work is *memoizable*.  This cache sits in
front of it (`PipelineExecutor._encode_chunk`, both staged and monolithic
dispatch): a hit returns the previously computed embeddings (a tuple of
tensors) and skips tokenize + text-encode entirely.

Keys are ``(family, tokenizer_hash, prompts, negative_prompts)`` for one
prepared-width chunk -- the tokenizer hash keeps two models (or two
tokenizer revisions) from ever sharing an entry, and chunk-level keying
means the cached value is exactly the encode stage's output (no
per-prompt splitting of a batched embedding).

Hit/miss counts land in the owning server's `MetricsRegistry`
(``serve_prompt_cache``); `hit_rate()` is what the JAX package's SLO
controller reads to discount its predicted service time.

Thread model: stage workers and the scheduler thread call concurrently;
the map is lock-guarded, the encode itself runs OUTSIDE the lock (a miss
must not serialize every other stage worker behind a text-encode), so two
racing misses may both encode -- both produce the identical value, and
one wins the insert.  Entries hold device tensors that the encode made
for this entry alone (never a captured graph's static input, which the
next replay would overwrite); the LRU bound is the memory bound.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable
from ..utils import sync

_MISSING = object()


class PromptCache:
    """Bounded LRU of encoded-prompt embeddings (see module docstring)."""

    def __init__(self, capacity: int, counter=None):
        assert capacity >= 1, capacity
        self.capacity = int(capacity)
        # utils.metrics.Counter (registry-owned) or None: keys "hits" /
        # "misses" / "evictions" -- the MetricsRegistry hit-rate surface
        self.counter = counter
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = sync.Lock()
        self._hits = 0
        self._misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _count(self, name: str) -> None:
        if self.counter is not None:
            self.counter.inc(name)

    def get(self, key: Hashable) -> Any:
        """The cached value, or the module-private MISSING sentinel (never
        None -- an encoder may legitimately return a falsy value)."""
        with self._lock:
            v = self._entries.get(key, _MISSING)
            if v is not _MISSING:
                self._entries.move_to_end(key)
                self._hits += 1
            else:
                self._misses += 1
        self._count("hits" if v is not _MISSING else "misses")
        return v

    def put(self, key: Hashable, value: Any) -> None:
        evicted = 0
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                evicted += 1
        for _ in range(evicted):
            self._count("evictions")

    def get_or_encode(self, key: Hashable, encode: Callable[[], Any]) -> Any:
        """Return the cached embeddings for ``key``, encoding (outside the
        lock) and inserting on a miss."""
        v = self.get(key)
        if v is _MISSING:
            v = encode()
            self.put(key, v)
        return v

    def hit_rate(self) -> float:
        with self._lock:
            total = self._hits + self._misses
            return self._hits / total if total else 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            total = self._hits + self._misses
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self._hits,
                "misses": self._misses,
                "hit_rate": self._hits / total if total else 0.0,
            }
