"""Request/result types for the inference engine.

Port of ``repro.serving.request``: the same fields and metrics, plus
``keep_logits``/``first_logits``, which hand a request its first-token
logits."""

from __future__ import annotations

import enum
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

_ids = itertools.count()


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    DONE = "done"
    CANCELLED = "cancelled"


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0            # 0 => greedy
    stop_tokens: tuple = (1,)           # EOS id of data.tokenizer
    request_id: int = field(default_factory=lambda: next(_ids))
    arrival_time: float = field(default_factory=time.monotonic)
    state: RequestState = RequestState.QUEUED
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    # megastep accounting: tokens arrive in blocks of up to K per host
    # sync, so timing is tracked at block granularity
    first_token_time: Optional[float] = None
    finished_time: Optional[float] = None
    # streaming: fired as (request, token, index) from the engine's host
    # sync points — once per generated token, in generation order
    on_token: Optional[Callable[["Request", int, int], None]] = None
    # admission class: higher jumps ahead of lower in the engine queue
    # (never preempts running decodes) — the reference's front door maps
    # SLOClass.INTERACTIVE here
    priority: int = 0
    # prompt tokens whose K/V came from the prefix cache instead of being
    # prefilled (0 on a miss or without sharing): the per-request half of
    # EngineStats.prefix_tokens_reused
    prefix_tokens: int = 0
    # first-token logits: when keep_logits is set, the engine copies the
    # request's f32 logits row (padded vocab) to the host at its prefill
    # wave's sync (used to hold one engine against another)
    keep_logits: bool = False
    first_logits: Optional[Any] = None

    @property
    def done(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.CANCELLED)

    @property
    def ttft_seconds(self) -> Optional[float]:
        """Time to first token: queueing + admission + prefill. This is the
        latency half of the metric split — never folded into decode
        throughput."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def decode_seconds(self) -> Optional[float]:
        """Wall time from first token to completion (None while running)."""
        if self.first_token_time is None or self.finished_time is None:
            return None
        return self.finished_time - self.first_token_time

    @property
    def tokens_per_second(self) -> Optional[float]:
        """Per-request DECODE throughput: tokens after the first over the
        ``first_token``-relative window only. Prefill and queueing time are
        deliberately excluded from the denominator — they belong to
        ``ttft_seconds`` — so streamed requests never conflate the two
        (``end_to_end_tokens_per_second`` is the conflated whole-lifetime
        rate, reported alongside, never in place of this)."""
        dt = self.decode_seconds
        if dt is None or len(self.generated) <= 1:
            return None
        return (len(self.generated) - 1) / max(dt, 1e-9)

    @property
    def end_to_end_tokens_per_second(self) -> Optional[float]:
        """Whole-lifetime rate (arrival -> finish, prefill + queueing in
        the denominator). Useful for capacity math; NOT a decode-speed
        metric."""
        if self.finished_time is None or not self.generated:
            return None
        dt = self.finished_time - self.arrival_time
        return len(self.generated) / max(dt, 1e-9)


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0         # derived from device-side produced counts
    completed: int = 0
    steps: int = 0
    prefill_batches: int = 0
    megasteps: int = 0             # fused-decode dispatches (<= decode_tokens)
    # kernel libraries this engine built (0 when they were on disk or
    # already loaded): a warm context compiles nothing. A shell rebuilt
    # from a wire recipe that finds a library already built (by another
    # process, in a shared build directory) counts it under
    # aot_cache_hits instead, so "zero builds" holds across processes
    compiles: int = 0
    aot_cache_hits: int = 0
    decode_seconds: float = 0.0    # wall time inside megastep dispatch+sync
    # decode_step calls run (a megastep runs up to K of them); each runs
    # every layer's decode attention once
    decode_steps: int = 0
    # the decode storage the engine resolved to at construction: "paged"
    # (page pool behind a page table) or "full" (the slot cache)
    decode_path: str = "full"
    # page-pool occupancy as of the most recent megastep (paged path only)
    live_pages: int = 0
    # page-level prefix sharing: admissions that hit the prefix cache,
    # prompt tokens whose prefill was skipped because their K/V pages were
    # already resident, and copy-on-write page copies (the boundary-page
    # copy of a shared prefill and the decode-append copy before a
    # megastep)
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    cow_copies: int = 0

    @property
    def decode_tokens_per_second(self) -> float:
        return self.decode_tokens / max(self.decode_seconds, 1e-9)

    def as_dict(self) -> Dict:
        return dict(prefill_tokens=self.prefill_tokens,
                    decode_tokens=self.decode_tokens,
                    completed=self.completed, steps=self.steps,
                    prefill_batches=self.prefill_batches,
                    megasteps=self.megasteps, compiles=self.compiles,
                    aot_cache_hits=self.aot_cache_hits,
                    decode_seconds=self.decode_seconds,
                    decode_steps=self.decode_steps,
                    decode_path=self.decode_path,
                    live_pages=self.live_pages,
                    prefix_hits=self.prefix_hits,
                    prefix_tokens_reused=self.prefix_tokens_reused,
                    cow_copies=self.cow_copies)
