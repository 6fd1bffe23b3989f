"""Continuously batched inference engine with fused decode megasteps.

Port of ``repro.serving.engine.InferenceEngine`` with the contiguous slot
cache. A fixed number of decode SLOTS share one KV cache allocated once;
the weights, that cache and the per-slot decode state (lengths, last
tokens, temperatures, active mask, generated counts, max-new budgets,
stop-token table, the RNG) live on the device for the engine's lifetime
and together form the PCM *context*.

**Admission.** ``submit`` keeps a priority queue (higher ``priority``
first, FIFO within a class). Every ``step()`` first admits queued prompts
into free slots (``admission="continuous"``; ``"drain"`` waits until no
slot is active), then runs one decode megastep. A prefill wave is bucketed
to the smallest ``prefill_buckets`` length that holds its longest prompt
and padded to the full slot count; the valid rows' K/V are written
straight into their slots (the reference built a second, transient wave
cache and merged it). The wave syncs with the host once, for the first
tokens and the done flags.

**The megastep.** One megastep generates up to ``megastep=K`` tokens per
slot with every mask on the device: free and finished slots sample
nothing, advance nothing and write nothing to the cache (their rows stay
bit-identical), and stop-token, max-new-token and cache-overflow checks
run on the device. The host syncs ONCE per megastep, for a (slots, K)
token block, per-slot produced counts and the active mask. PyTorch runs
eagerly, so the number of decode steps is fixed before launch from what
the host knows: the largest remaining budget of an active slot, or, when
requests are queued under continuous admission, the smallest (the earliest
slot that can free up), capped at K. A slot that stops on a stop token
mid-megastep idles until the megastep ends; greedy outputs are the same
for every K and whatever shares the batch.

**Kernels.** With ``cfg.use_kernels`` on a CUDA device, prefill and decode
attention run in the hand-written kernels of ``repro_torch/csrc``; the
engine builds them at construction when they are not on disk yet, and
``stats.compiles`` counts those builds (0 for a warm context).

**Demote and restore (PCM snapshot hooks).** ``offload_device_state()``
copies the weights, the slot cache, the per-slot state and the RNG state
into (pinned) host tensors and frees the device memory;
``restore_device_state()`` copies them back. A restored engine decodes
bit-identically to one that never left the device, and rebuilds nothing:
the restore costs the transfer only.

The paged pool and prefix sharing (``paged=True``) come in a later slice.
"""

from __future__ import annotations

import collections
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.serving import kvcache
from repro_torch.serving.request import EngineStats, Request, RequestState
from repro_torch.serving.sampler import sample

NO_TOKEN = -1  # stop-table padding: never matches a real (>= 0) token id

_STATE_FIELDS = ("lengths", "last_tokens", "temps", "active_mask",
                 "gen_counts", "max_news", "stop_table")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest prefill bucket "
                     f"({buckets[-1]}) — prompts must never be silently "
                     f"truncated")


class InferenceEngine:
    def __init__(self, model, *, device: Union[str, torch.device] = "cuda",
                 slots: int = 8, cache_len: int = 512,
                 prefill_buckets: Sequence[int] = (32, 128, 512),
                 cache_dtype: torch.dtype = torch.float32, rng_seed: int = 0,
                 megastep: int = 1, max_stop_tokens: int = 4,
                 admission: str = "continuous", paged: bool = False):
        dev = devices.resolve(device)
        if paged:
            raise NotImplementedError(
                "paged=True: the paged KV pool (serving/paged.py) and its "
                "paged_flash_decode kernel arrive in the next port slice")
        if admission not in ("continuous", "drain"):
            raise ValueError(f"admission must be 'continuous' or 'drain', "
                             f"got {admission!r}")
        if model.device.type != dev.type:
            raise ValueError(f"model lives on {model.device}, engine asked "
                             f"for {dev}")
        self.device = model.device
        self.model = model
        self.cfg = model.cfg
        self.slots = slots
        self.cache_len = cache_len
        # every admissible prompt (submit enforces len <= cache_len) gets a
        # bucket that holds it whole
        self.prefill_buckets = tuple(sorted(
            set(min(b, cache_len) for b in prefill_buckets) | {cache_len}))
        self.megastep = int(megastep)
        if self.megastep < 1:
            raise ValueError(f"megastep must be >= 1, got {megastep}")
        self.admission = admission
        self.max_stop_tokens = max_stop_tokens

        self.stats = EngineStats()
        self.compile_seconds = 0.0
        if self.cfg.use_kernels and self.device.type == "cuda":
            from repro_torch.kernels import build
            info = build.build_all()
            self.stats.compiles = len(info["built"])
            self.compile_seconds = info["seconds"]

        d = self.device
        self.cache = model.init_cache(slots, cache_len, cache_dtype)
        self.lengths = torch.zeros(slots, dtype=torch.int32, device=d)
        self.last_tokens = torch.zeros(slots, dtype=torch.int32, device=d)
        self.temps = torch.zeros(slots, dtype=torch.float32, device=d)
        self.active_mask = torch.zeros(slots, dtype=torch.bool, device=d)
        self.gen_counts = torch.zeros(slots, dtype=torch.int32, device=d)
        self.max_news = torch.zeros(slots, dtype=torch.int32, device=d)
        self.stop_table = torch.full((slots, max_stop_tokens), NO_TOKEN,
                                     dtype=torch.int32, device=d)
        self._gen = torch.Generator(device=d)
        self._gen.manual_seed(rng_seed)
        self._host_lengths = np.zeros((slots,), np.int64)

        self.queue: collections.deque = collections.deque()
        self.active: Dict[int, Request] = {}          # slot -> request
        self.free_slots: collections.deque = collections.deque(range(slots))

    # -------------------------------------------- PCM tier offload/restore --
    @property
    def offloaded(self) -> bool:
        """True while the engine's device state lives in host memory."""
        return self.cache is None

    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        pin = t.device.type == "cuda"
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=pin)
        host.copy_(t, non_blocking=pin)
        return host

    def offload_device_state(self) -> Dict:
        """Demote: copy every device-resident tensor (weights, slot cache,
        per-slot decode state) and the RNG state to host memory (pinned
        when the device is the card) and free the device copies. The queue,
        the host length shadow, the stats and the built kernels stay on
        this object; a later ``restore_device_state`` needs no rebuild.
        Offloading twice raises."""
        if self.offloaded:
            raise RuntimeError("engine device state is already offloaded")
        params = dict(self.model.named_parameters())
        host = {
            "params": {n: self._host_copy(p) for n, p in params.items()},
            "cache": {n: self._host_copy(t) for n, t in self.cache.items()},
            "_rng": self._gen.get_state(),
        }
        for name in _STATE_FIELDS:
            host[name] = self._host_copy(getattr(self, name))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for p in params.values():
            p.data = torch.empty((0,), dtype=p.dtype, device=self.device)
        self.cache = None
        for name in _STATE_FIELDS:
            setattr(self, name, None)
        return host

    def restore_device_state(self, host_state: Dict) -> None:
        """Promote: copy a state dict from ``offload_device_state`` back
        onto the device. The restored engine decodes bit-identically to
        one that never left it."""
        if not self.offloaded:
            raise RuntimeError("engine device state is already resident")
        missing = [n for n in ("params", "cache", "_rng") + _STATE_FIELDS
                   if n not in host_state]
        if missing:
            raise ValueError(f"snapshot is missing engine state: {missing}")
        d = self.device

        def put(t):
            return t.to(d, non_blocking=t.is_pinned())

        params = dict(self.model.named_parameters())
        if set(params) != set(host_state["params"]):
            raise ValueError("snapshot weights do not match the model's "
                             "parameters")
        for n, p in params.items():
            p.data = put(host_state["params"][n])
        self.cache = {n: put(t) for n, t in host_state["cache"].items()}
        for name in _STATE_FIELDS:
            setattr(self, name, put(host_state[name]))
        self._gen.set_state(host_state["_rng"])
        if d.type == "cuda":
            torch.cuda.synchronize(d)

    def _require_resident(self):
        if self.offloaded:
            raise RuntimeError(
                "engine device state is offloaded (context demoted to host "
                "memory) — restore the context before use")

    # -------------------------------------------------------------- public --
    def submit(self, req: Request) -> Request:
        if len(req.prompt) > self.cache_len:
            raise ValueError(f"prompt ({len(req.prompt)}) exceeds cache "
                             f"({self.cache_len})")
        if len(req.stop_tokens) > self.max_stop_tokens:
            raise ValueError(f"request has {len(req.stop_tokens)} stop "
                             f"tokens; engine supports at most "
                             f"{self.max_stop_tokens}")
        if any(t < 0 for t in req.stop_tokens):
            raise ValueError("stop tokens must be non-negative ids")
        if req.priority > 0:
            # ahead of every queued request of strictly lower priority,
            # behind equal-or-higher (FIFO within class)
            idx = next((i for i, q in enumerate(self.queue)
                        if q.priority < req.priority), len(self.queue))
            self.queue.insert(idx, req)
        else:
            self.queue.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def step(self) -> List[Request]:
        """Admit queued prefills into free slots, then one decode megastep
        (up to K tokens) for all active slots. Returns finished requests.
        In ``drain`` mode admission waits for the active set to empty."""
        self._require_resident()
        finished: List[Request] = []
        if self.queue and self.free_slots and (
                self.admission == "continuous" or not self.active):
            finished.extend(self._admit_wave())
        if self.active:
            finished.extend(self._megastep_wave())
        self.stats.steps += 1
        return finished

    def run_to_completion(self) -> List[Request]:
        done = []
        while self.has_work():
            done.extend(self.step())
        return done

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature: float = 0.0
                 ) -> List[List[int]]:
        reqs = [self.submit(Request(prompt=list(p),
                                    max_new_tokens=max_new_tokens,
                                    temperature=temperature))
                for p in prompts]
        self.run_to_completion()
        return [r.generated for r in reqs]

    def cancel(self, req: Request) -> bool:
        """Withdraw a request: a queued one is removed, a running one has
        its slot freed and its device row deactivated (no host sync), other
        slots undisturbed. Returns False when the request is finished or
        unknown to this engine."""
        if req.done:
            return False
        try:
            self.queue.remove(req)
            req.state = RequestState.CANCELLED
            req.finished_time = time.monotonic()
            return True
        except ValueError:
            pass
        s = req.slot
        if s is None or self.active.get(s) is not req:
            return False
        self._require_resident()
        del self.active[s]
        self.free_slots.append(s)
        self._host_lengths[s] = 0
        self.active_mask[s] = False
        self.lengths[s] = 0
        req.state = RequestState.CANCELLED
        req.finished_time = time.monotonic()
        return True

    # ------------------------------------------------------------ internal --
    @torch.no_grad()
    def _admit_wave(self) -> List[Request]:
        n = min(len(self.queue), len(self.free_slots))
        wave = [self.queue.popleft() for _ in range(n)]
        wave_slots = [self.free_slots.popleft() for _ in range(n)]
        bucket = _bucket(max(len(r.prompt) for r in wave),
                         self.prefill_buckets)
        toks = np.zeros((self.slots, bucket), np.int32)
        lens = np.zeros((self.slots,), np.int32)
        temps = np.zeros((self.slots,), np.float32)
        max_new = np.zeros((self.slots,), np.int32)
        stops = np.full((self.slots, self.max_stop_tokens), NO_TOKEN,
                        np.int32)
        for i, r in enumerate(wave):
            toks[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
            temps[i] = r.temperature
            max_new[i] = r.max_new_tokens
            stops[i, :len(r.stop_tokens)] = r.stop_tokens
            r.state = RequestState.PREFILLING
            r.slot = wave_slots[i]

        d = self.device
        valid = torch.arange(self.slots, device=d) < n
        slot_t = torch.as_tensor(wave_slots, dtype=torch.long, device=d)
        lens_t = torch.as_tensor(lens, device=d)
        temps_t = torch.as_tensor(temps, device=d)
        max_new_t = torch.as_tensor(max_new, device=d)
        stops_t = torch.as_tensor(stops, device=d)
        logits = self.model.prefill(torch.as_tensor(toks, device=d), lens_t,
                                    self.cache, slots=slot_t)
        first = sample(logits, self._gen, temps_t,
                       vocab_size=self.cfg.vocab_size, active=valid)
        # on-device done detection for the first token: stop token,
        # max_new_tokens == 1, or a prompt that already fills the cache
        stopped = (first[:, None] == stops_t).any(dim=1)
        row_active = valid & ~(stopped | (max_new_t <= 1)
                               | (lens_t >= self.cache_len - 1))
        self.lengths[slot_t] = lens_t[:n]
        self.last_tokens[slot_t] = first[:n]
        self.temps[slot_t] = temps_t[:n]
        self.active_mask[slot_t] = row_active[:n]
        self.gen_counts[slot_t] = 1
        self.max_news[slot_t] = max_new_t[:n]
        self.stop_table[slot_t] = stops_t[:n]

        # one host sync per wave: the first tokens and done flags
        host = torch.stack([first[:n], row_active[:n].to(torch.int32)]).cpu()
        if any(r.keep_logits for r in wave):
            rows = logits[:n].float().cpu()
            for i, r in enumerate(wave):
                if r.keep_logits:
                    r.first_logits = rows[i]
        first_np, row_active_np = host.numpy()
        now = time.monotonic()
        done: List[Request] = []
        for i, r in enumerate(wave):
            tok = int(first_np[i])
            r.generated.append(tok)
            r.first_token_time = now
            r.state = RequestState.DECODING
            self._host_lengths[r.slot] = len(r.prompt)
            if r.on_token is not None:
                self._emit(r, tok, 0)
            if row_active_np[i]:
                self.active[r.slot] = r
            else:
                done.append(self._finish(r))
        self.stats.prefill_tokens += int(lens.sum())
        self.stats.prefill_batches += 1
        return done

    def _megastep_steps(self) -> int:
        """Decode steps of the next megastep, from host-tracked state only:
        the largest remaining budget of an active slot (max-new tokens or
        cache room), or the smallest when queued requests wait for a slot,
        capped at K."""
        rem = [min(r.max_new_tokens - len(r.generated),
                   self.cache_len - 1 - int(self._host_lengths[s]))
               for s, r in self.active.items()]
        waiting = bool(self.queue) and self.admission == "continuous"
        return max(1, min(self.megastep, min(rem) if waiting else max(rem)))

    @torch.no_grad()
    def _megastep_wave(self) -> List[Request]:
        t0 = time.monotonic()
        n_steps = self._megastep_steps()
        B, K = self.slots, self.megastep
        lengths, last = self.lengths, self.last_tokens
        act, gen = self.active_mask, self.gen_counts
        block = torch.zeros((B, K), dtype=torch.int32, device=self.device)
        produced = torch.zeros(B, dtype=torch.int32, device=self.device)
        for step in range(n_steps):
            logits = self.model.decode_step(last[:, None], lengths,
                                            self.cache, active=act)
            toks = sample(logits, self._gen, self.temps,
                          vocab_size=self.cfg.vocab_size, active=act,
                          fallback=last)
            lengths = torch.where(act, lengths + 1, lengths)
            gen = torch.where(act, gen + 1, gen)
            block[:, step] = torch.where(act, toks, 0)
            produced += act.to(torch.int32)
            stopped = (toks[:, None] == self.stop_table).any(dim=1)
            act = act & ~(stopped | (gen >= self.max_news)
                          | (lengths >= self.cache_len - 1))
            last = toks
        # zero finished/free slots' lengths: later megasteps attend over a
        # single masked position for them (admission rewrites lengths; the
        # host tracks real lengths in its shadow)
        self.lengths = torch.where(act, lengths, 0)
        self.last_tokens, self.active_mask, self.gen_counts = last, act, gen
        self.stats.decode_steps += n_steps

        # the single host sync for up to K tokens across all slots
        host = torch.cat([block, produced[:, None],
                          act[:, None].to(torch.int32)], dim=1).cpu().numpy()
        block_np, produced_np, active_np = host[:, :K], host[:, K], host[:, K + 1]
        now = time.monotonic()
        done: List[Request] = []
        for s, r in list(self.active.items()):
            k = int(produced_np[s])
            if k:
                base = len(r.generated)
                toks_s = [int(t) for t in block_np[s, :k]]
                r.generated.extend(toks_s)
                if r.on_token is not None:
                    for j, t in enumerate(toks_s):
                        self._emit(r, t, base + j)
            if not active_np[s]:
                del self.active[s]
                done.append(self._finish(r, now))
        self._host_lengths += produced_np
        self.stats.decode_tokens += int(produced_np.sum())
        self.stats.megasteps += 1
        self.stats.decode_seconds += time.monotonic() - t0
        return done

    def _emit(self, r: Request, token: int, index: int):
        """Fire a request's streaming callback; a raising callback is
        reported and dropped (the stream breaks, not the engine)."""
        try:
            r.on_token(r, token, index)
        except BaseException:
            print(f"on_token callback failed for request {r.request_id}:",
                  file=sys.stderr)
            traceback.print_exc(file=sys.stderr)

    def _finish(self, r: Request, now: Optional[float] = None) -> Request:
        r.state = RequestState.DONE
        r.finished_time = now if now is not None else time.monotonic()
        self.free_slots.append(r.slot)
        self.stats.completed += 1
        return r

    def snapshot(self) -> Dict:
        """Engine-state summary. ``capacity_bytes`` is the allocated cache
        (what device memory pays), ``live_bytes`` the part the active
        slots' contexts fill, pro-rated by host-tracked lengths."""
        if self.offloaded:
            cap = live = 0
        else:
            cap = kvcache.capacity_bytes(self.cache)
            live_tokens = sum(int(self._host_lengths[s])
                              for s in self.active)
            live = int(cap * min(1.0, live_tokens
                                 / (self.slots * self.cache_len)))
        return {
            "active": len(self.active), "queued": len(self.queue),
            "free_slots": len(self.free_slots),
            "admission": self.admission,
            "offloaded": self.offloaded,
            "cache_bytes": cap,
            "capacity_bytes": cap,
            "live_bytes": live,
            "decode_path": "full",
            "compile_seconds": self.compile_seconds,
            "stats": self.stats.as_dict(),
        }
