"""Host-side data pipeline: deterministic, shardable, resumable.

Produces LM training batches from the synthetic FEVER stream (claim text ->
"claim ... answer : LABEL" sequences) or from a pure synthetic-token stream
for throughput work. Sharding is by (host_id, host_count) slicing of the
global index space; resumability is an explicit ``start_step`` (the loop
checkpoints its step counter, nothing else is stateful).

Copied from ``repro.data.pipeline`` (the port imports nothing of the JAX
package): the same numpy batches, byte for byte, for the same config and
step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data import fever
from repro_torch.data.tokenizer import EOS, LABEL_TOKENS, HashTokenizer


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 49_152
    seed: int = 0
    host_id: int = 0
    host_count: int = 1
    task: str = "fact"          # fact | synthetic


def _pack_example(tok: HashTokenizer, claim: fever.Claim, seq_len: int,
                  template: str = fever.DEFAULT_PROMPT):
    prompt = tok.encode(fever.render_prompt(claim, template))
    target = [LABEL_TOKENS[claim.label], EOS]
    ids = (prompt + target)[:seq_len + 1]
    tokens = np.zeros(seq_len + 1, np.int32)
    tokens[:len(ids)] = ids
    labels = np.full(seq_len + 1, -100, np.int32)
    lo = min(len(prompt), seq_len)
    labels[lo:len(ids)] = tokens[lo:len(ids)]
    return tokens[:-1], labels[1:]


def batches(cfg: PipelineConfig, start_step: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    tok = HashTokenizer(cfg.vocab_size)
    step = start_step
    rng = np.random.default_rng(cfg.seed + 1000 * cfg.host_id)
    while True:
        if cfg.task == "synthetic":
            toks = rng.integers(8, cfg.vocab_size,
                                size=(cfg.batch_size, cfg.seq_len + 1),
                                dtype=np.int32)
            yield {"tokens": toks[:, :-1].astype(np.int32),
                   "labels": toks[:, 1:].astype(np.int32)}
            step += 1
            continue
        base = (step * cfg.host_count + cfg.host_id) * cfg.batch_size
        idx = [int(i) % fever.FEVER_SIZE
               for i in range(base, base + cfg.batch_size)]
        claims = fever.claim_batch(idx, cfg.seed)
        toks = np.zeros((cfg.batch_size, cfg.seq_len), np.int32)
        labels = np.zeros((cfg.batch_size, cfg.seq_len), np.int32)
        for i, c in enumerate(claims):
            toks[i], labels[i] = _pack_example(tok, c, cfg.seq_len)
        yield {"tokens": toks, "labels": labels}
        step += 1
