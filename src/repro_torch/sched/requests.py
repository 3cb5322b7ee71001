"""Request lifecycle for the continuous-batching scheduler (the port's copy
of ``repro.sched.requests``).

A ``Request`` is what a client submits: prompt tokens, a decode budget,
sampling parameters, and (optionally) an ``SLOSpec`` — priority class and
TTFT/TPOT deadlines the SLO-aware scheduler acts on. ``RequestState`` is
the scheduler's view of it moving through QUEUED → PREFILL → DECODE →
DONE:

- QUEUED   — waiting in the arrival queue (not yet admitted: no slot, no
             capacity reservation);
- PREFILL  — admitted: prompt being prefilled into its batch slot. With
             chunked prefill (``SchedulerConfig.chunk_size``) this state
             persists across scheduler steps — ``prefill_pos`` tracks how
             many prompt tokens have landed, and the partial batch-1 row
             cache lives on ``chunk_cache`` between steps (resident mode)
             or parked page-by-page in the memory pool (kv_offload mode);
- DECODE   — joined the running batch; one token per scheduler step;
- DONE     — produced ``max_new_tokens``; slot freed, reservation released,
             pages dropped.

Two SLO-mode-only states branch off that spine:

- PREEMPTED — was PREFILL or DECODE; its slot was handed to a deadline-
              pressed higher-priority arrival. The KV rows live on
              ``chunk_cache`` (resident) or stay parked in the pool
              (kv_offload); the capacity reservation is *kept* (the pages
              really occupy pool space), so restoring never re-admits.
              Resumes to its prior state when a slot frees — token stream
              byte-identical to an unpreempted run;
- SHED      — dropped from the queue before admission because its TTFT
              deadline was already unmeetable (goodput: no prefill spent
              on certainly-missed work). Terminal, like DONE, but with no
              output.

Each admitted request owns a ``KVPageTable`` (offload.kvcache): its slice
of the stacked decode cache, page-granular, living in the memory pool when
the scheduler runs with ``kv_offload=True``. At ``temperature > 0`` a
request samples from its own ``torch.Generator`` seeded with its
``seed`` — the stream a batch-1 ``ServeEngine.generate`` with that seed
draws from — first from the prefill logits, then once per decode step.
Greedy decoding (``temperature=0``) is token-identical to serving each
request alone; sampled tokens cannot reproduce the JAX package's
``jax.random`` bits.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Optional

import numpy as np

import torch

from repro_torch.offload.kvcache import KVPageTable
from repro_torch.slo.policy import SLOSpec

QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"
PREEMPTED = "PREEMPTED"
SHED = "SHED"

_REQUEST_IDS = itertools.count()


@dataclasses.dataclass
class Request:
    """One client request: prompt ids (1-D), decode budget, sampling."""

    tokens: np.ndarray                 # (S,) int32 prompt ids
    max_new_tokens: int
    arrival: float = 0.0               # scheduler-clock arrival time
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    slo: Optional[SLOSpec] = None      # None → standard class, no deadlines
    req_id: int = dataclasses.field(default_factory=lambda: next(_REQUEST_IDS))

    def __post_init__(self) -> None:
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def total_len(self) -> int:
        """Worst-case sequence length (prompt + all generated tokens)."""
        return self.prompt_len + self.max_new_tokens


@dataclasses.dataclass
class RequestState:
    """Scheduler-side mutable state of one request."""

    request: Request
    status: str = QUEUED
    slot: Optional[int] = None         # batch row while admitted
    pos: int = 0                       # next cache write index for decode
    prefill_pos: int = 0               # prompt tokens prefilled so far (chunked)
    chunk_cache: Optional[Any] = None  # partial row cache between chunk steps
    last_tok: int = -1                 # token fed to the next decode step
    out: List[int] = dataclasses.field(default_factory=list)
    gen: Optional[torch.Generator] = None   # per-request sampling stream
    pages: Optional[KVPageTable] = None
    prefix_hit: Optional[Any] = None   # PrefixHit while admitted (refs held)
    reserve_key: str = ""              # pool reservation handle
    preemptions: int = 0               # times parked mid-flight (SLO mode)
    last_step: int = -1                # last scheduler step that decoded us
    joined_step: int = -1
    t_joined: Optional[float] = None   # admission time (queue-wait metric)
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def done(self) -> bool:
        return len(self.out) >= self.request.max_new_tokens

    def generator(self, device: torch.device) -> torch.Generator:
        """The request's sampling stream on ``device``, seeded with its
        ``seed`` at first use; every sampled token draws from it."""
        if self.gen is None:
            self.gen = torch.Generator(device=device).manual_seed(
                self.request.seed)
        return self.gen

    def tokens_array(self) -> np.ndarray:
        return np.asarray(self.out, np.int32)
