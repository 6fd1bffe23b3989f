"""Synthetic FEVER-style fact-verification dataset (Prompt-for-Fact).

Copied as it is from ``repro.data.fever`` so that claims and prompts match
the reference exactly (the port imports nothing of the JAX package).

The paper sweeps 145,449 FEVER claims with SmolLM2 as a verifier. Offline,
we generate claims from a closed synthetic world model (capitals, authors,
years, ...) so labels are *derivable*: a model can actually learn the task
and a prompt's verification accuracy is a real, reproducible number — which
is what the Prompt-for-Fact application optimizes.

Deterministic by (seed, index): any worker can materialize any slice
without coordination (the high-throughput task model of the paper).
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Dict, Iterator, List, Sequence, Tuple

FEVER_SIZE = 145_449
LABELS = ("SUPPORTED", "REFUTED", "NOT ENOUGH INFO")

_WORLD = {
    "capital": [("paris", "france"), ("tokyo", "japan"), ("lima", "peru"),
                ("oslo", "norway"), ("cairo", "egypt"), ("rome", "italy"),
                ("madrid", "spain"), ("ottawa", "canada"),
                ("canberra", "australia"), ("nairobi", "kenya")],
    "author": [("orwell", "1984"), ("austen", "emma"), ("kafka", "trial"),
               ("melville", "mobydick"), ("joyce", "ulysses"),
               ("woolf", "orlando"), ("tolstoy", "war"),
               ("dante", "inferno")],
    "element": [("hydrogen", "1"), ("helium", "2"), ("carbon", "6"),
                ("oxygen", "8"), ("iron", "26"), ("gold", "79"),
                ("neon", "10"), ("silicon", "14")],
}

_TEMPLATES = {
    "capital": "{a} is the capital of {b}",
    "author": "{a} wrote {b}",
    "element": "{a} has atomic number {b}",
}

_UNKNOWN_SUBJECTS = ["zorblax", "quixel", "vantor", "mirelle", "koppen",
                     "drayune", "selvath", "ombrix"]


@dataclasses.dataclass(frozen=True)
class Claim:
    index: int
    text: str
    label: str

    @property
    def label_id(self) -> int:
        return LABELS.index(self.label)


def make_claim(index: int, seed: int = 0) -> Claim:
    rng = random.Random(
        int.from_bytes(hashlib.md5(f"{seed}:{index}".encode()).digest()[:8],
                       "little"))
    domain = rng.choice(sorted(_WORLD))
    facts = _WORLD[domain]
    a, b = rng.choice(facts)
    roll = rng.random()
    if roll < 0.4:
        label = "SUPPORTED"
    elif roll < 0.8:
        # corrupt the object with another domain entry
        label = "REFUTED"
        b = rng.choice([x for _, x in facts if x != b])
    else:
        label = "NOT ENOUGH INFO"
        a = rng.choice(_UNKNOWN_SUBJECTS)
    text = _TEMPLATES[domain].format(a=a, b=b)
    return Claim(index=index, text=text, label=label)


def claims(n: int = FEVER_SIZE, seed: int = 0, start: int = 0
           ) -> Iterator[Claim]:
    for i in range(start, start + n):
        yield make_claim(i, seed)


def claim_batch(indices: Sequence[int], seed: int = 0) -> List[Claim]:
    return [make_claim(i, seed) for i in indices]


DEFAULT_PROMPT = ("claim : {claim} . question : is this claim true ? "
                  "answer :")

PROMPT_CANDIDATES = (
    DEFAULT_PROMPT,
    "verify : {claim} . verdict :",
    "fact check the statement {claim} . result :",
    "statement : {claim} . label :",
)


def render_prompt(claim: Claim, template: str = DEFAULT_PROMPT) -> str:
    return template.format(claim=claim.text)
