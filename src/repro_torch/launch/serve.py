"""Batched serving: prefill a batch of prompts, then decode tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --reduced --device cpu

Serves every family of ``configs/all_configs.py``.  Runs on the CUDA card
unless ``--device cpu`` is given.  With ``--attention-impl flash`` (the
default) every prefill self-attention goes through the hand-written K1
kernel: the decoder's (causal) and, for the enc-dec family, the encoder's
(non-causal); cross-attention takes the dot path, as in the JAX package.
Every prefill Mamba-2 layer (the SSM and hybrid families) goes through K2.
The enc-dec family gets seeded frame embeddings [B, source_len, D] * 0.02
and the vlm family a seeded image prefix [B, num_image_tokens, D] * 0.02,
as ``repro.launch.serve`` draws them.  Decode attention on the card goes
through K3 (``kernels/decode_attention.py``, which the JAX package has no
twin of); the rest of a decode step is the plain path, as in the JAX
package.  ``run(cfg=...)`` takes a config whose depth was cut.
``serve_batch`` is the serve loop of one batch, which ``run`` calls.

``--trace PATH`` runs the batch under ``torch.profiler`` (the CPU, and CUDA
on the card), writes the profiler's Chrome export to PATH and the program's
spans (``core.scope``: tag, ids, times, attributes such as bytes copied) to
PATH.spans.jsonl, and prints a table by span tag, for the whole batch and
for one decode step: count, host ms in all and less the spans inside
("self"), kernel launches, device idle ms, each put down to the innermost
span open at that moment, and GiB counted by the spans' byte attributes;
then how the process's decode steps ran (``models/decode_graph.py``: a
CUDA graph captured, replayed, or the step run eagerly):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --batch 4 --prompt-len 16384 --gen 16 --trace build/mamba2.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core import scope
from repro_torch.core.scope import named_scope
from repro_torch.models import decode_graph
from repro_torch.models.lm import LM, resolve_device


@dataclass
class ServeResult:
    tokens: np.ndarray            # [B, gen] generated token ids
    prompts: torch.Tensor         # [B, S]
    prefill_logits: torch.Tensor  # [B, 1, V_pad]
    prefill_s: float
    decode_s: float
    lm: LM
    inputs: dict                  # enc_embeds / embeds_prefix given to forward


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
    ap.add_argument("--trace", metavar="PATH",
                    help="profile the batch: the Chrome export to PATH, the spans beside it")
    return ap.parse_args(argv)


def grow_cache(cfg, cache, max_len: int):
    """Grow a prefill cache to ``max_len`` positions for decoding: the KV
    entries (k/v [L,B,S,K,hd] or [G,B,S,K,hd], scales [...,S,K]) are
    zero-padded along the sequence axis.  The enc-dec family grows ``self``
    and keeps ``cross`` at the source length; the hybrid family grows
    ``attn`` and keeps ``ssm`` and ``conv``, which have no sequence axis,
    as the SSM family does."""
    def grow(kv):
        with named_scope("grow_cache") as sp:
            out = {name: F.pad(x, [0, 0] * (x.dim() - 3) + [0, max_len - x.shape[2]])
                   for name, x in kv.items()}
            if sp.recording:    # read and written
                sp.note(bytes=sum(x.nbytes + out[name].nbytes for name, x in kv.items()))
            return out

    if cfg.family == "ssm":
        return cache
    if cfg.family == "encdec":
        return {"self": grow(cache["self"]), "cross": cache["cross"]}
    if cfg.family == "hybrid":
        return {"attn": grow(cache["attn"]), "ssm": cache["ssm"], "conv": cache["conv"]}
    return grow(cache)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample(logits, temperature, generator):
    """The next token [B, 1], on the device and copied to the host: the
    argmax at temperature 0, else drawn from the tempered softmax."""
    with named_scope("sample"):
        if temperature > 0:
            probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return tok, tok.cpu()


def serve_batch(lm, prompts, gen, *, kv_dtype="bfloat16", temperature=0.0, generator=None,
                inputs=None, on_token=None):
    """One batch: prefill ``prompts`` [B, S] (with ``inputs``, the enc-dec
    family's ``enc_embeds`` or the vlm family's ``embeds_prefix``), grow the
    cache, decode.  Of the ``gen`` tokens the first is the prefill's argmax,
    the rest are drawn at ``temperature`` with ``generator``.  Each token is
    copied to the host as it is made and passed to ``on_token(i, tok)``
    (tok [B, 1] on the host).  Returns (tokens [B, gen] on the host, the
    prefill's logits, prefill seconds with the cache grown, decode seconds)."""
    cfg, device = lm.cfg, lm.device
    B, S = prompts.shape
    n_img = cfg.num_image_tokens
    host = []

    def emit(tok_host):
        host.append(tok_host)
        if on_token is not None:
            on_token(len(host) - 1, tok_host)

    with torch.inference_mode(), named_scope("serve.batch", batch=B, prompt=S, gen=gen):
        _sync(device)
        t0 = time.perf_counter()
        out = lm.forward(prompts, mode="prefill", kv_dtype=kv_dtype, **(inputs or {}))
        cache = grow_cache(cfg, out["cache"], S + gen + n_img)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        tok, tok_host = _sample(out["logits"], 0.0, None)
        emit(tok_host)
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = lm.decode(cache, tok, S + n_img + i)
            tok, tok_host = _sample(logits, temperature, generator)
            emit(tok_host)
        t_decode = time.perf_counter() - t0
    return torch.cat(host, dim=1).numpy(), out["logits"], t_prefill, t_decode


@contextlib.contextmanager
def _profiled(path, device: torch.device):
    """Profile the block; write the Chrome export to ``path`` and the spans to
    ``path``.spans.jsonl, and print the spans' table (``scope.attribute``)."""
    from torch.profiler import ProfilerActivity, profile
    scope.clear()
    with profile(activities=[ProfilerActivity.CPU]
                 + [ProfilerActivity.CUDA] * (device.type == "cuda")) as prof:
        yield
    prof.export_chrome_trace(path)
    spans = scope.spans()
    with open(f"{path}.spans.jsonl", "w") as f:
        for s in spans:
            f.write(json.dumps(s._asdict()) + "\n")
    events = prof.profiler.kineto_results.events()
    steps = scope.subtree(spans, "decode")
    n = sum(s.tag == "decode" for s in spans)
    print(f"[serve] trace: {path}; {len(spans)} spans ({scope.dropped()} dropped)")
    print(_table("the batch", scope.attribute(spans, events), 1))
    if n:
        rows = scope.attribute(steps, events)
        rows.pop("(none)", None)          # the time between the steps
        print(_table(f"one decode step (mean of {n})", rows, n))
    print("[serve] decode steps by how they ran: " + ", ".join(
        f"{how} {n}" for how, n in decode_graph.COUNTS.items()))


def _table(title, rows, per):
    """The spans' table, ``per`` steps to a row's numbers, largest self ms first."""
    lines = [f"[serve] spans, {title}: tag, count, host ms, self ms, launches, "
             "device idle ms, GiB"]
    for tag, r in sorted(rows.items(), key=lambda kv: -kv[1]["self_ms"]):
        lines.append(f"  {tag:<16}{r['count'] / per:>9.1f}{r['host_ms'] / per:>11.3f}"
                     f"{r['self_ms'] / per:>11.3f}{r['launches'] / per:>10.1f}"
                     f"{r['idle_ms'] / per:>11.3f}{r['gib'] / per:>10.3f}")
    return "\n".join(lines)


def _config(args, cfg=None):
    """The config to serve: ``--arch`` (``--reduced``), or ``cfg``, which may
    differ from it in depth only."""
    base = get_config(cfg.name if cfg is not None else args.arch)
    if args.reduced:
        base = base.reduced()
    if cfg is not None:
        if dataclasses.replace(cfg, num_layers=base.num_layers) != base \
                or not 0 < cfg.num_layers <= base.num_layers:
            raise ValueError(f"cfg= may cut only the depth of {base.name}")
        if cfg.num_layers != base.num_layers:
            print(f"[serve] {cfg.name}: depth cut to {cfg.num_layers} of "
                  f"{base.num_layers} layers")
        base = cfg
    return dataclasses.replace(base, attention_impl=args.attention_impl)


def run(argv=None, *, cfg=None) -> ServeResult:
    """Build the model from ``--seed``, prefill seeded prompts and decode.
    ``cfg`` replaces ``--arch``'s config by one whose ``num_layers`` was cut
    (for the hybrid family, still a multiple of ``attn_period``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = _config(args, cfg)
    lm = LM(cfg, device=device, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    B, S = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)
    kw = {}
    if cfg.encoder is not None:
        kw["enc_embeds"] = torch.randn((B, cfg.encoder.source_len, cfg.d_model),
                                       generator=gen, device=device) * 0.02
    if cfg.num_image_tokens:
        kw["embeds_prefix"] = torch.randn((B, cfg.num_image_tokens, cfg.d_model),
                                          generator=gen, device=device) * 0.02
    with _profiled(args.trace, device) if args.trace else contextlib.nullcontext():
        toks, logits, t_prefill, t_decode = serve_batch(
            lm, prompts, args.gen, kv_dtype=args.kv_dtype, temperature=args.temperature,
            generator=gen, inputs=kw)
    return ServeResult(tokens=toks, prompts=prompts, prefill_logits=logits,
                       prefill_s=t_prefill, decode_s=t_decode, lm=lm, inputs=kw)


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
