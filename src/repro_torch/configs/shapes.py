"""The assigned input-shape suites (applies to every LM-family architecture).

Copied as it is from ``repro.configs.shapes`` (the port imports nothing of
the JAX package).

``train_*`` shapes lower ``train_step``; ``prefill_*`` lower the prefill pass;
``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache / recurrent state of ``seq_len``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSuite:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int
    needs_subquadratic: bool = False


TRAIN_4K = ShapeSuite("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeSuite("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeSuite("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeSuite("long_500k", "decode", 524_288, 1, needs_subquadratic=True)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg) -> list:
    """Applicable shape suites for a config.

    ``long_500k`` needs sub-quadratic attention: it runs for SSM/hybrid archs
    and SWA archs (bounded KV window); pure full-attention archs skip it
    (recorded in DESIGN.md §Arch-applicability).
    """
    out = []
    for s in ALL_SHAPES:
        if s.needs_subquadratic and not is_subquadratic(cfg):
            continue
        out.append(s)
    return out


def is_subquadratic(cfg) -> bool:
    if cfg.family in ("ssm", "hybrid"):
        return True
    if cfg.attention == "sliding_window" and cfg.sliding_window and cfg.swa_every == 1:
        return True
    return False


def skip_reason(cfg, suite: ShapeSuite) -> str | None:
    if suite.needs_subquadratic and not is_subquadratic(cfg):
        return ("full-attention arch: 500k decode would hold a quadratic-cost "
                "KV cache; skipped per assignment rules (see DESIGN.md)")
    return None
