"""Module-level builders and tasks for the port's multi-host tests.

The counterpart of ``multihost_helpers.py`` for ``repro_torch``: every
recipe and task that crosses the socket is pickled by reference, so it
must live at module level, and the worker node processes import this
module by name (``spawn_node_process(extra_path=(tests dir,))``). It
imports only ``repro_torch`` and the standard library.
"""

from __future__ import annotations

import os
import time

from repro_torch.core import load_context, make_recipe
from repro_torch.launch.serve import build_context

# the reduced smollm2-1.7b engine every node builds: a slot cache of two
# slots, one 16-token prefill bucket
ENGINE = dict(slots=2, cache_len=64, prefill_buckets=(16,))


def engine_recipe(checkpoint, megastep: int, name: str = "mh-smol",
                  device: str = "cpu", cfg=None):
    """The reduced smollm2-1.7b context (or ``cfg``) on ``device``, its
    weights the latest checkpoint under ``checkpoint`` (the seeded init
    when None). The default footprints are the paper's, so the planner
    prices a PEER bootstrap under a cold fetch."""
    return make_recipe(
        f"{name}-k{megastep}", build_context,
        ("smollm2-1.7b", ENGINE["slots"], ENGINE["cache_len"], megastep,
         cfg, device, checkpoint, ENGINE["prefill_buckets"]))


def generate_task(prompts, max_new_tokens: int = 6, seconds: float = 0.0):
    """Greedy-decode ``prompts`` on the held engine after sleeping
    ``seconds`` (to keep a worker busy). Returns the tokens, the pid of
    the process that ran it and the engine's build counters."""
    time.sleep(seconds)
    eng = load_context("engine")
    out = eng.generate(prompts, max_new_tokens=max_new_tokens)
    return out, os.getpid(), {"compiles": eng.stats.compiles,
                              "aot_cache_hits": eng.stats.aot_cache_hits}
