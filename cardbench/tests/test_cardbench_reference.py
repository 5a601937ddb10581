"""The plain references against the program at a reduced size on the CPU:
the prefill logits of the last position and every decode step through the
cache, on weights drawn from a seed."""
import ast
from pathlib import Path

import pytest
import torch

from cardbench import families, port, weights
from cardbench.reference import dense, ssm
from cardbench.tests.tiny import BENCH, REPO, tiny_config

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def serve(lm, prompts, gen):
    """Prefill, grow the cache, greedy decode: the logits of every step."""
    from repro_torch.launch.serve import grow_cache
    S = prompts.shape[1]
    with torch.inference_mode():
        out = lm.forward(prompts, mode="prefill", kv_dtype="bfloat16")
        cache = grow_cache(lm.cfg, out["cache"], S + gen)
        logits = [out["logits"][:, -1].float()]
        tok = logits[-1].argmax(-1)[:, None]
        toks = [tok]
        for i in range(gen - 1):
            step, cache = lm.decode(cache, tok, S + i)
            logits.append(step[:, -1].float())
            tok = logits[-1].argmax(-1)[:, None]
            toks.append(tok)
    return torch.stack(logits, 1), torch.cat(toks, 1)


@pytest.mark.parametrize("name,ref", [("tiny-dense", dense), ("tiny-ssm", ssm)])
def test_reference_matches_the_program(name, ref):
    cfg = families.at_root(tiny_config(name), REPO)
    w = weights.draw(cfg, 7, "cpu")
    lm = port.build(cfg, w)
    B, S, gen = 2, 40, 6         # the ssm's chunk of 16 splits S into 3 chunks
    prompts = torch.randint(0, cfg["vocab_size"], (B, S),
                            generator=torch.Generator().manual_seed(3))
    got, toks = serve(lm, prompts, gen)
    V = cfg["vocab_size"]
    for b in range(B):
        seq = torch.cat([prompts[b], toks[b, :-1]])
        want = ref.logits(w, cfg, seq, torch.arange(S - 1, S + gen - 1))
        scale = want.abs().max()
        # bf16 activations through two layers: ~0.5% of the largest logit
        err = (got[b, :, :V] - want).abs().max()
        assert err < 2e-2 * scale, (err, scale)
        # the float8 control departs further than the bf16 program does
        ctrl = ref.logits(w, cfg, seq, torch.arange(S - 1, S + gen - 1), fp8=True)
        assert (ctrl - want).abs().max() > err


def test_ssd_chunks_agree_with_the_recurrence():
    g = torch.Generator().manual_seed(0)
    S, H, P, G, N = 37, 4, 3, 2, 5
    x, B, C = torch.randn(S, H, P, generator=g), torch.randn(S, G, N, generator=g), \
        torch.randn(S, G, N, generator=g)
    dt = torch.rand(S, H, generator=g)
    A = -1.0 - 3 * torch.rand(H, generator=g)
    old = ssm.CHUNK, ssm.CHUNKS_AT_ONCE
    try:
        ssm.CHUNK, ssm.CHUNKS_AT_ONCE = 8, 2
        y = ssm.ssd(x, dt, A, B, C)
    finally:
        ssm.CHUNK, ssm.CHUNKS_AT_ONCE = old
    h = torch.zeros(H, P, N)
    for t in range(S):
        Bh, Ch = B[t].repeat_interleave(H // G, 0), C[t].repeat_interleave(H // G, 0)
        h = torch.exp(dt[t] * A)[:, None, None] * h + (dt[t][:, None] * x[t])[..., None] * Bh[:, None]
        assert torch.allclose(y[t], torch.einsum("hpn,hn->hp", h, Ch), atol=1e-4)


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & FORBIDDEN
