"""Batched serving engine over the model's decode path.

Modes:
- resident (default): the KV cache stays in device memory — the paper's
  inference baseline.
- ``offload_kv=True``: between decode steps the whole cache is stored into
  the memory pool's host tier and prefetched back through the async
  transfer engine — the Store/Prefetch round trip, with capacity accounting
  and traffic stats from the ``MemoryPoolManager``.

Batching: one uniform-length prompt batch per ``generate()`` call. The
engine runs on the device its parameters live on.

``jit_prefill``, ``jit_decode`` and ``jit_prefill_chunk`` are the
counterparts of the reference's shared entry points, which the continuous
scheduler calls: plain callables over the model that run it under
``torch.inference_mode()``. Nothing is compiled — PyTorch runs eagerly —
and where the reference donates the cache, the model writes it in place.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.device import device_of
from repro_torch.models.model import Model
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.pool import MemoryPoolManager, auto_depth
from repro_torch.serving.sampling import sample_token


@dataclasses.dataclass
class ServeStats:
    prefill_tokens: int = 0
    decoded_tokens: int = 0
    cache_round_trips: int = 0


# per-engine pool-key namespace: engines sharing one pool never collide
_ENGINE_IDS = itertools.count()


def _inference(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)
    return call


# shared per model (keyed by the hashable frozen Model), bounded as the
# reference's compiled entry points are
@functools.lru_cache(maxsize=64)
def jit_prefill(model: Model) -> Callable:
    """``model.prefill(params, batch, cache)`` under inference mode."""
    return _inference(model.prefill)


@functools.lru_cache(maxsize=64)
def jit_decode(model: Model) -> Callable:
    """``model.decode_step(params, cache, token, pos)`` under inference
    mode; the cache is written in place."""
    return _inference(model.decode_step)


@functools.lru_cache(maxsize=64)
def jit_prefill_chunk(model: Model) -> Callable:
    """``model.prefill_chunk(params, batch, offset, valid_len, cache)``
    under inference mode: one fixed (1, chunk_size) token shape, the row
    cache written in place."""
    return _inference(model.prefill_chunk)


def _flatten(tree: Any) -> Tuple[List[torch.Tensor], Any]:
    """Leaves of a nested dict/list of tensors, dict keys in sorted order
    (the reference's ``jax.tree.flatten`` order), plus a rebuild spec."""
    if isinstance(tree, torch.Tensor):
        return [tree], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return [x for p in parts for x in p[0]], ("dict", keys,
                                                  [p[1] for p in parts])
    parts = [_flatten(t) for t in tree]
    return [x for p in parts for x in p[0]], ("list", len(parts),
                                              [p[1] for p in parts])


def _unflatten(spec: Any, leaves: List[torch.Tensor]) -> Any:
    return _build(spec, iter(leaves))


def _build(spec: Any, it: Iterator[torch.Tensor]) -> Any:
    # module-level, not a closure over itself: a self-referencing closure is
    # a reference cycle, and it would keep each step's cache leaves alive
    # until the garbage collector happened to run
    if spec is None:
        return next(it)
    kind, keys, subs = spec
    if kind == "dict":
        return {k: _build(sub, it) for k, sub in zip(keys, subs)}
    return [_build(sub, it) for sub in subs]


class ServeEngine:
    def __init__(self, model: Model, params: Any, *, max_seq: int,
                 cache_dtype: torch.dtype = torch.float32,
                 offload_kv: bool = False,
                 pool: Optional[MemoryPoolManager] = None,
                 tracer=None) -> None:
        self.model = model
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.params = params
        self.device = device_of(params)
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.offload_kv = offload_kv
        if offload_kv and pool is None:
            raise ValueError("ServeEngine(offload_kv=True) requires a pool "
                             "(repro_torch.pool.default_pool)")
        if offload_kv:
            if pool.device != self.device:
                raise ValueError(f"pool on {pool.device}, parameters on "
                                 f"{self.device}")
            # one whole cache's leaves issue before any wait
            pool.transfer.ensure_depth(auto_depth(layers=model.cfg.n_layers))
        self.pool = pool
        self._key_ns = f"serve{next(_ENGINE_IDS)}"
        self._kv_keys: list = []     # stable per-leaf pool keys
        self.stats = ServeStats()

    def pool_stats(self) -> Optional[Dict[str, Any]]:
        """Pool traffic/occupancy snapshot (None when serving resident)."""
        return self.pool.snapshot() if self.pool is not None else None

    # ------------------------------------------------------------------
    def _cache_round_trip(self, cache: Any) -> Any:
        """Store every cache leaf into the pool, then prefetch them all
        back through the transfer engine (fetches issue before any wait).
        Leaf keys are stable across steps: a re-``put`` replaces the entry
        in place (and reuses its host buffer)."""
        with self.tracer.span("serve", "cache_round_trip",
                              engine=self._key_ns):
            leaves, spec = _flatten(cache)
            while len(self._kv_keys) < len(leaves):
                self._kv_keys.append(f"{self._key_ns}/kv{len(self._kv_keys)}")
            keys = self._kv_keys[:len(leaves)]
            for k, leaf in zip(keys, leaves):
                self.pool.put(k, leaf)   # topology's default store tier
            del leaves                   # the device copies can go now
            handles = [self.pool.prefetch(k) for k in keys]
            self.stats.cache_round_trips += 1
            return _unflatten(spec, [h.wait() for h in handles])

    def _release_cache_keys(self) -> None:
        for k in self._kv_keys:
            if k in self.pool:
                self.pool.drop(k)

    def generate(self, batch: Dict[str, torch.Tensor], max_new_tokens: int,
                 *, temperature: float = 0.0, top_k: Optional[int] = None,
                 seed: int = 0) -> torch.Tensor:
        """batch["tokens"]: (B, S_prompt) int → generated ids
        (B, max_new_tokens) int32 on the engine's device."""
        tokens = batch["tokens"]
        b, s0 = tokens.shape
        if s0 + max_new_tokens > self.max_seq:
            raise ValueError(f"prompt {s0} + {max_new_tokens} new tokens "
                             f"exceeds max_seq {self.max_seq}")
        with self.tracer.span("serve", "generate", engine=self._key_ns,
                              batch=b, prompt_len=s0,
                              max_new_tokens=max_new_tokens), \
                torch.inference_mode():
            return self._generate(tokens.to(self.device), max_new_tokens,
                                  temperature=temperature, top_k=top_k,
                                  seed=seed)

    def _generate(self, tokens: torch.Tensor, max_new_tokens: int, *,
                  temperature: float, top_k: Optional[int],
                  seed: int) -> torch.Tensor:
        b, s0 = tokens.shape
        cache = self.model.init_cache(b, self.max_seq, self.cache_dtype,
                                      device=self.device)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens},
                                           cache)
        self.stats.prefill_tokens += b * s0

        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        tok = sample_token(logits[:, 0], gen, temperature=temperature,
                           top_k=top_k)
        out.append(tok)
        try:
            for i in range(1, max_new_tokens):
                pos = s0 + i - 1
                if self.offload_kv:
                    cache = self._cache_round_trip(cache)   # Store + Prefetch
                # decode writes the cache in place (the reference donates it)
                logits, cache = self.model.decode_step(self.params, cache,
                                                       tok[:, None], pos)
                tok = sample_token(logits[:, 0], gen, temperature=temperature,
                                   top_k=top_k)
                out.append(tok)
                self.stats.decoded_tokens += b
        finally:
            # standing cache entries must not haunt a shared pool
            if self.offload_kv:
                self._release_cache_keys()
        return torch.stack(out, dim=1)
