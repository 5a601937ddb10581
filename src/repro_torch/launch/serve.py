"""Batched serving: prefill a batch of prompts, then decode tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --batch 4 --prompt-len 1024 --gen 32

Runs on the CUDA card unless ``--device cpu`` is given.  For the dense
family with ``--attention-impl flash`` (the default) the prefill's
attention goes through the hand-written K1 kernel; for the SSM family
(mamba2) every prefill layer's SSD goes through K2, and
``--attention-impl`` has no effect.  The decode steps use the plain path,
as in the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.models.lm import LM, resolve_device


@dataclass
class ServeResult:
    tokens: np.ndarray            # [B, gen] generated token ids
    prompts: torch.Tensor         # [B, S]
    prefill_logits: torch.Tensor  # [B, 1, V_pad]
    prefill_s: float
    decode_s: float
    lm: LM


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-dtype", default="bfloat16")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attention-impl", default="flash",
                    choices=["auto", "dot", "chunked", "flash"])
    return ap.parse_args(argv)


def grow_cache(cfg, cache, max_len: int):
    """Grow a prefill cache to ``max_len`` positions for decoding: the KV
    entries of the dense family (k/v [L,B,S,K,hd], scales [L,B,S,K]) are
    zero-padded along the sequence axis; the SSM family's ``ssm`` and
    ``conv`` states have no sequence axis and stay as they are."""
    if cfg.family == "ssm":
        return cache
    return {name: F.pad(x, [0, 0] * (x.dim() - 3) + [0, max_len - x.shape[2]])
            for name, x in cache.items()}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> ServeResult:
    """Build the model from ``--seed``, prefill seeded prompts and decode."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    lm = LM(cfg, device=device, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    B, S = args.batch, args.prompt_len
    max_len = S + args.gen
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        out = lm.forward(prompts, mode="prefill", kv_dtype=args.kv_dtype)
        cache = grow_cache(cfg, out["cache"], max_len)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(out["logits"][:, -1], dim=-1)[:, None]
        generated = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            logits, cache = lm.decode(cache, tok, S + i)
            if args.temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / args.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            else:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            generated.append(tok)
        toks = torch.cat(generated, dim=1).cpu().numpy()
        t_decode = time.perf_counter() - t0
    return ServeResult(tokens=toks, prompts=prompts, prefill_logits=out["logits"],
                       prefill_s=t_prefill, decode_s=t_decode, lm=lm)


def main(argv=None):
    args = parse_args(argv)
    res = run(argv)
    B, gen = args.batch, args.gen
    print(f"[serve] arch={res.lm.cfg.name} batch={B} prompt={args.prompt_len} gen={gen}")
    print(f"[serve] prefill {res.prefill_s*1e3:.1f} ms; decode "
          f"{res.decode_s/max(gen-1,1)*1e3:.1f} ms/token "
          f"({B*(gen-1)/max(res.decode_s,1e-9):.1f} tok/s)")
    print(f"[serve] sample continuations: {res.tokens[:2, :8].tolist()}")
    return res.tokens


if __name__ == "__main__":
    main()
