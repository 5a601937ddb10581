"""The one generator of traffic: it reads a mix's file and yields batches.

A mix is a JSON file under ``traffic/``::

    {"batch": 4,                                  # prompts in a batch
     "entries": [{"prompt": 16384, "output": 16}, ...],
     "check_requests": 8}                         # requests the output check samples

A closed loop: one client sends the next batch when the last one has ended.
Each cycle sends every entry once, as one batch of ``batch`` prompts of the
entry's length, in an order drawn from the seed; the prompts' token ids are
drawn from the seed too.  So every seed sends the same set of sizes, in
another order.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed derived from ``seed`` (any whole number) and ``keys``."""
    ss = np.random.SeedSequence([int(k) % 2**64 for k in (seed, *keys)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass(frozen=True)
class Batch:
    index: int          # the batch's place in the run, from 0
    cycle: int
    prompt: int         # tokens in each prompt
    output: int         # tokens served for each prompt
    size: int           # prompts in the batch


class Mix:
    def __init__(self, params: dict, name: str = ""):
        self.name = name
        self.batch = int(params["batch"])
        self.entries = [(int(e["prompt"]), int(e["output"])) for e in params["entries"]]
        self.check_requests = int(params["check_requests"])
        if self.batch < 1 or not self.entries or self.check_requests < 1:
            raise ValueError(f"traffic {name!r}: want batch >= 1, entries and check_requests >= 1")
        if any(p < 1 or o < 1 for p, o in self.entries):
            raise ValueError(f"traffic {name!r}: every prompt and output needs a token")

    @classmethod
    def load(cls, path: Path) -> "Mix":
        return cls(json.loads(Path(path).read_text()), name=Path(path).stem)

    def shapes(self):
        """The distinct (prompt, output) pairs, the shapes a run warms up."""
        return sorted(set(self.entries))

    def cycle(self, seed: int, c: int, first_index: int):
        """The batches of cycle ``c``: every entry once, in a seeded order."""
        order = np.random.default_rng(sub_seed(seed, 1, c)).permutation(len(self.entries))
        return [Batch(first_index + i, c, *self.entries[j], self.batch)
                for i, j in enumerate(order)]

    def prompts(self, seed: int, batch: Batch, vocab: int, device):
        """The token ids [size, prompt] of ``batch``, drawn on ``device``."""
        import torch
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2, batch.index))
        return torch.randint(0, vocab, (batch.size, batch.prompt), generator=g, device=device)
