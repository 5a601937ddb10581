"""The check that decides ``correct``: the served tokens against the plain
reference.

Once the window has closed, a sample of the finished requests, drawn from
the seed and always holding one of the longest, goes through the reference:
one full causal pass over the prompt and the tokens served before the last,
in float32.  At each served token's position the reading is the gap by
which the reference's logit of that token lies below the reference's best
logit.  The number compared is the widest gap over the sample (``max_gap``);
greedy decoding serves the token the program ranks first, so a sound bf16
program reads a small gap and a step gone wrong a large one.

The control puts the reference in the program's place at float8 operands:
at each position the token it ranks first is read against the float32
reference the same way (``control_max_gap``).
"""
from __future__ import annotations

import numpy as np

from cardbench import families
from cardbench.traffic import sub_seed


def sample(batches, n: int, seed: int):
    """``n`` (batch record, row) pairs drawn from the seed, one of them of
    the longest requests (prompt plus output) of the run."""
    reqs = [(b, row) for b in batches for row in range(b.batch.size)]
    rng = np.random.default_rng(sub_seed(seed, 3))
    longest = max(b.batch.prompt + b.batch.output for b, _ in reqs)
    first = [i for i, (b, _) in enumerate(reqs) if b.batch.prompt + b.batch.output == longest]
    pick = [first[rng.integers(len(first))]]
    rest = [i for i in range(len(reqs)) if i != pick[0]]
    pick += list(rng.permutation(rest)[:max(0, n - 1)])
    return [reqs[i] for i in pick]


def gaps(w, cfg, requests, control=False):
    """The reference's gaps, one array per request: of each served token
    and, with ``control``, of the token the float8 control ranks first."""
    import torch
    ref = families.reference(cfg)
    V = cfg["vocab_size"]
    served, ctrl = [], []
    for rec, row in requests:
        prompt = rec.prompts[row]
        toks = torch.as_tensor(rec.tokens[row], device=prompt.device)
        S, n = prompt.shape[0], toks.shape[0]
        seq = torch.cat([prompt, toks[:-1]])
        pos = torch.arange(S - 1, S + n - 1, device=prompt.device)
        r = ref.logits(w, cfg, seq, pos)
        best = r.max(dim=-1).values
        ok = (toks >= 0) & (toks < V)
        got = r.gather(1, toks.clamp(0, V - 1)[:, None])[:, 0]
        served.append(torch.where(ok, best - got, torch.inf).cpu().numpy())
        if control:
            picks = ref.logits(w, cfg, seq, pos, fp8=True).argmax(dim=-1)
            ctrl.append((best - r.gather(1, picks[:, None])[:, 0]).cpu().numpy())
        del r
    return served, ctrl
