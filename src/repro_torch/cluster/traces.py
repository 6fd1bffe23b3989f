"""Capacity traces for the paper's four experiment regimes, plus the
open-loop arrival generator for the streaming front door.

A capacity trace is ``capacity_fn(t) -> list[profile_name]`` — the
opportunistic slots the cluster exposes at time t (what the TaskVine
factory sees). ``poisson_sessions`` is the LOAD side of the same story:
deterministic open-loop session arrival times, shared by the frontdoor
benchmark and simulator-backed session tests so both replay the identical
workload.
"""

from __future__ import annotations

import hashlib
import math
import random
from typing import Callable, List

from repro_torch.cluster.devices import cluster_census

# the paper's standard 20-GPU pool: half A10, half TITAN X (Pascal)
STATIC_20 = ["a10"] * 10 + ["titan-x-pascal"] * 10


def static(profiles: List[str] = None) -> Callable[[float], List[str]]:
    profiles = STATIC_20 if profiles is None else profiles

    def capacity(t: float) -> List[str]:
        return list(profiles)

    return capacity


def rq3_aggressive_preemption(start_at: float = 900.0,
                              period: float = 60.0,
                              pool: List[str] = None,
                              floor: int = 0
                              ) -> Callable[[float], List[str]]:
    """From ``start_at``, 1 GPU preempted per ``period`` seconds, A10s
    first (paper §4.4), until the pool is depleted. ``pool`` defaults to
    the paper's 20-GPU mix; live elastic runs pass a smaller pool (and a
    time-compressed ``start_at``/``period``) to get the same depletion
    shape at laptop scale. ``floor`` keeps that many slots alive forever —
    the paper's runs deplete fully (floor=0, the sweep strands), a live
    demo that must drain its queue keeps floor>=1."""
    base = list(STATIC_20 if pool is None else pool)

    def capacity(t: float) -> List[str]:
        lost = 0 if t < start_at else int((t - start_at) // period) + 1
        keep = max(min(floor, len(base)), len(base) - lost)
        rev = base[::-1]                # TITAN X last -> preempt A10s first
        return rev[:keep][::-1]

    return capacity


def rq4_low_capacity(ramp_every: float = 240.0,
                     start: int = 4, cap: int = 20,
                     pool: List[str] = None
                     ) -> Callable[[float], List[str]]:
    """Scarce cluster: start with ``start`` GPUs, one more every
    ``ramp_every`` seconds up to ``cap`` (drawn from ``pool``, default the
    paper's 20-GPU mix)."""
    base = list(STATIC_20 if pool is None else pool)

    def capacity(t: float) -> List[str]:
        n = min(min(cap, len(base)), start + int(t // ramp_every))
        return base[:n]

    return capacity


def rq4_high_capacity(peak: int = 186, ramp_seconds: float = 420.0
                      ) -> Callable[[float], List[str]]:
    """Many jobs exiting: capacity floods in quickly up to 186 slots
    (32.8% of the 567-GPU cluster), drawn from the real census mix."""
    census = cluster_census()
    # deterministic shuffle of the census
    census = sorted(census, key=lambda name: hashlib.md5(
        name.encode() + str(census.index(name)).encode()).hexdigest())
    pool = [census[i * 3 % len(census)] for i in range(peak)]

    def capacity(t: float) -> List[str]:
        frac = min(1.0, 0.02 + 0.98 * t / ramp_seconds)
        return pool[:max(4, int(peak * frac))]

    return capacity


def poisson_sessions(rate: float, duration: float,
                     seed: int = 0) -> List[float]:
    """Open-loop Poisson session arrivals: sorted arrival times in
    ``[0, duration)`` with exponential inter-arrival gaps of mean
    ``1/rate`` (arrivals/second). Deterministic in ``seed`` — the
    frontdoor benchmark and the simulator backend replay the exact same
    schedule. Open-loop means arrivals never wait for service: this is the
    load model that exposes queueing (and shedding) behaviour, unlike
    closed-loop drivers whose offered load collapses under slowdown."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if duration < 0:
        raise ValueError(f"duration must be non-negative, got {duration}")
    rng = random.Random(seed)
    out: List[float] = []
    t = rng.expovariate(rate)
    while t < duration:
        out.append(t)
        t += rng.expovariate(rate)
    return out


def churn(base: int = 16, amplitude: int = 8, period: float = 600.0
          ) -> Callable[[float], List[str]]:
    """Sinusoidal capacity churn (stress trace for scheduler tests)."""
    census = cluster_census()

    def capacity(t: float) -> List[str]:
        n = base + int(amplitude * math.sin(2 * math.pi * t / period))
        return [census[i * 7 % len(census)] for i in range(max(1, n))]

    return capacity
