#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for the float32 comparisons;
2. build: compile every kernel of the serve path from ``src/repro_torch/
   kernels/csrc`` into ``build/kernels`` and print the build seconds;
3. kernels: hold each kernel against its plain PyTorch version on the card;
4. serve: ``repro_torch.launch.serve`` on internlm2-1.8b at full width
   (24 layers, seeded random bf16 weights), batch 4, prompt 1024, 32 new
   tokens, flash prefill; count the kernel launches of that run, check the
   logits, prefill->decode consistency, and flash against dot prefill;
5. times: kernel, plain version, library call and serve times, as JSON.

The last line of standard output is the device line
``{"ok": true, "device": {...}}``.  The script imports nothing of jax or
of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

SERVE_ARGS = ["--arch", "internlm2-1.8b", "--batch", "4", "--prompt-len", "1024",
              "--gen", "32", "--attention-impl", "flash", "--kv-dtype", "bfloat16",
              "--seed", "0", "--device", "cuda"]
SERVE_SHAPE = dict(B=4, Sq=1024, Skv=1024, H=16, K=8, hd=128)   # internlm2-1.8b


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


# ------------------------------------------------------------------ phases
def check_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke run needs a CUDA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"{torch.cuda.get_device_name(0)}, power limit not read"
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def build_kernels():
    from repro_torch.kernels import build
    path, seconds = build.build("flash_attention")
    log(f"built {path.relative_to(ROOT)} in {seconds:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return seconds


def _qkv(B, Sq, Skv, H, K, hd, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda", dtype=torch.float32).to(dtype)
    return mk(B, H, Sq, hd), mk(B, K, Skv, hd), mk(B, K, Skv, hd)


def check_k1():
    """K1 against its plain version on the card; returns the serve-shape error."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_hmajor,
                                                     flash_attention_hmajor_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []   # (name, shape, dtype, kwargs, tolerance)
    for shape in [(2, 128, 128, 4, 2, 64), (1, 100, 100, 4, 4, 128), (2, 64, 64, 8, 2, 32),
                  (1, 128, 256, 4, 1, 64), (1, 257, 129, 2, 2, 256)]:
        for causal in (True, False):
            cases.append((f"f32 {shape} causal={causal}", shape, f32,
                          dict(causal=causal), 2e-5))
    for window in (8, 64, 200):
        cases.append((f"f32 window={window}", (1, 128, 128, 4, 2, 64), f32,
                      dict(causal=True, window=window), 2e-5))
    cases.append(("bf16 (1,128,128,4,4,64)", (1, 128, 128, 4, 4, 64), bf16,
                  dict(causal=True), 3e-2))
    cases.append(("f32 ragged windowed GQA", (2, 300, 300, 8, 2, 96), f32,
                  dict(causal=True, window=37), 2e-5))
    cases.append(("f32 ragged kv_valid hd=16", (2, 77, 200, 4, 2, 16), f32,
                  dict(causal=False, kv_valid=150), 2e-5))
    s = SERVE_SHAPE
    serve_shape = (s["B"], s["Sq"], s["Skv"], s["H"], s["K"], s["hd"])
    cases.append(("bf16 serve shape", serve_shape, bf16, dict(causal=True), 3e-2))
    cases.append(("bf16 serve shape, peaked scores", serve_shape, bf16, dict(causal=True), 3e-2))

    serve_err = None
    for i, (name, (B, Sq, Skv, H, K, hd), dtype, kw, tol) in enumerate(cases):
        q, k, v = _qkv(B, Sq, Skv, H, K, hd, dtype, seed=i)
        if "peaked" in name:    # q, k at the std the serve model's init gives them
            q, k = (q.float() * 11.3).to(dtype), (k.float() * 11.3).to(dtype)
        out = flash_attention_hmajor(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = flash_attention_hmajor_plain(q, k, v, **kw)
        if out.dtype != dtype or out.shape != q.shape:
            fail(f"K1 {name}: got {out.dtype} {tuple(out.shape)}")
        a, b = out.float(), ref.float()
        err = (a - b).abs()
        bad = int((err > tol + tol * b.abs()).sum())
        max_err = float(err.max())
        log(f"K1 {name}: max_abs_err {max_err:.3e} (atol=rtol={tol}) "
            f"{'ok' if bad == 0 else f'{bad} entries out of tolerance'}")
        if bad or not torch.isfinite(a).all():
            fail(f"K1 disagrees with its plain version on {name}")
        if name == "bf16 serve shape":
            serve_err = max_err
    return serve_err


def run_serve():
    """The port's main path, with the kernel launch counts read around it."""
    from repro_torch.kernels.flash_attention import flash_attention_hmajor
    from repro_torch.launch import serve
    flash_attention_hmajor.launches = 0
    res = serve.run(SERVE_ARGS)
    launches = flash_attention_hmajor.launches
    cfg = res.lm.cfg
    log(f"serve: {cfg.name} L={cfg.num_layers} D={cfg.d_model} H={cfg.num_heads} "
        f"K={cfg.num_kv_heads} hd={cfg.head_dim} F={cfg.d_ff} V={cfg.vocab_size}: "
        f"prefill {res.prefill_s*1e3:.1f} ms, decode "
        f"{res.decode_s/31*1e3:.2f} ms/token, K1 launches {launches}")
    if launches != cfg.num_layers:
        fail(f"K1 launched {launches} times in the serve run, want {cfg.num_layers} "
             "(one per layer of the prefill)")
    return res, launches


def _consistency(lm, prompts, nxt, kv_dtype):
    """rel. max difference of the last logits: full forward against prefill
    followed by one decode step (tests/test_models_smoke.py:58-93)."""
    import torch
    import torch.nn.functional as F
    cfg = lm.cfg
    S = prompts.shape[1]
    full = lm.forward(torch.cat([prompts, nxt], 1), mode="train")["logits"]
    pf = lm.forward(prompts, mode="prefill", kv_dtype=kv_dtype)
    cache = {n: F.pad(x, [0, 0] * (x.dim() - 3) + [0, S]) for n, x in pf["cache"].items()}
    logits_d, _ = lm.decode(cache, nxt, S)
    a = full[:, -1, :cfg.vocab_size].float()
    b = logits_d[:, 0, :cfg.vocab_size].float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("train or decode logits are not finite")
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-6))


def _flash_vs_dot(lm, tokens, mode):
    """Distributional distance of flash logits from dot logits (the measures
    of tests/test_integration_extras.py:33-37), in train or prefill mode."""
    cfg = lm.cfg
    flash = lm.forward(tokens, mode=mode)["logits"][..., :cfg.vocab_size].float()
    lm.cfg = dataclasses.replace(cfg, attention_impl="dot")
    try:
        dot = lm.forward(tokens, mode=mode)["logits"][..., :cfg.vocab_size].float()
    finally:
        lm.cfg = cfg
    diff = (flash - dot).abs()
    return dict(mean_abs=float(diff.mean()), frac_lt_025=float((diff < 0.25).float().mean()),
                argmax_agree=float((flash.argmax(-1) == dot.argmax(-1)).float().mean()))


def _close(d):
    return d["mean_abs"] < 0.05 and d["frac_lt_025"] > 0.99 and d["argmax_agree"] > 0.95


def check_serve(res, check_layers=1):
    """Checks of the serve run's output.

    At full width the reference's init (fan-in of ``wq`` is its head count)
    gives attention scores with a standard deviation near 180, so each
    softmax is close to an argmax, and two attention paths that differ only
    in float rounding drift apart over 24 layers.  The model-level
    comparisons (prefill->decode, flash against dot) are therefore held to
    their limits on a model of the same width and init cut to
    ``check_layers`` layers, and reported, not held, at full depth.
    """
    import torch
    from repro_torch.models.lm import LM
    lm, prompts = res.lm, res.prompts
    cfg = lm.cfg
    if res.tokens.shape != (4, 32) or res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
        fail(f"serve tokens: shape {res.tokens.shape}, range "
             f"[{res.tokens.min()}, {res.tokens.max()}]")
    if not torch.isfinite(res.prefill_logits[..., :cfg.vocab_size].float()).all():
        fail("prefill logits are not finite")

    g = torch.Generator(device="cuda").manual_seed(5)
    nxt = torch.randint(0, cfg.vocab_size, (prompts.shape[0], 1), generator=g, device="cuda")
    full, cut = {}, {}
    with torch.inference_mode():
        full["bf16_prefill_decode_rel"] = _consistency(lm, prompts, nxt, "bfloat16")
        full["bf16_flash_vs_dot_prefill"] = _flash_vs_dot(lm, prompts, "prefill")
        short = LM(dataclasses.replace(cfg, num_layers=check_layers), device="cuda", seed=0)
        cut["bf16_prefill_decode_rel"] = _consistency(short, prompts, nxt, "bfloat16")
        cut["bf16_flash_vs_dot_train"] = _flash_vs_dot(short, prompts, "train")
        short.float()
        cut["f32_prefill_decode_rel"] = _consistency(short, prompts, nxt, "float32")
        cut["f32_flash_vs_dot_prefill"] = _flash_vs_dot(short, prompts, "prefill")
        del short
    log(f"serve checks at {cfg.num_layers} layers (reported): {json.dumps(full)}")
    log(f"serve checks at {check_layers} layers (held): {json.dumps(cut)}")
    for key in ("bf16_prefill_decode_rel", "f32_prefill_decode_rel"):
        if not cut[key] < 0.08:
            fail(f"{key}={cut[key]:.4f} at {check_layers} layers (limit 0.08)")
    for key in ("bf16_flash_vs_dot_train", "f32_flash_vs_dot_prefill"):
        if not _close(cut[key]):
            fail(f"{key} at {check_layers} layers out of bounds: {cut[key]}")
    return {"full_depth": full, f"{check_layers}_layers": cut}


def time_prefill(lm, prompts, n=3):
    """Warm prefill time (host clock around synchronised calls), median ms."""
    import torch
    times = []
    with torch.inference_mode():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.forward(prompts, mode="prefill")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _time_ms(fn, n=25, warmup=3):
    """Median over n single launches of CUDA-event time, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def time_k1():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_hmajor,
                                                     flash_attention_hmajor_plain)
    s = SERVE_SHAPE
    B, Sq, Skv, H, K, hd = s["B"], s["Sq"], s["Skv"], s["H"], s["K"], s["hd"]
    q, k, v = _qkv(B, Sq, Skv, H, K, hd, torch.bfloat16, seed=99)
    kernel_ms = _time_ms(lambda: flash_attention_hmajor(q, k, v, causal=True))
    plain_ms = _time_ms(lambda: flash_attention_hmajor_plain(q, k, v, causal=True))
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    # least time for the same work: the causal (q, k) pairs only (Sq == Skv here)
    pairs = Sq * (Sq + 1) // 2
    flops = 4 * hd * pairs * B * H                      # q.k and p.v, 2 flops per MAC
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def main():
    t_start = time.perf_counter()
    card = check_device()
    sys.path.insert(0, str(SRC))
    import torch

    build_s = build_kernels()
    serve_err = check_k1()
    res, launches = run_serve()
    checks = check_serve(res)
    prefill_warm_ms = time_prefill(res.lm, res.prompts)
    k1 = time_k1()
    gen = 32
    times = {
        "card": card,
        "build_s": build_s,
        "k1_serve_shape": {k: k1[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                              "bound_by", "flops", "bytes")},
        "k1_bound_us": k1["bound_ms"] * 1e3,
        "serve": {"arch": "internlm2-1.8b", "batch": 4, "prompt_len": 1024, "gen": gen,
                  "prefill_ms": res.prefill_s * 1e3,
                  "prefill_warm_ms": prefill_warm_ms,
                  "decode_ms_per_token": res.decode_s / (gen - 1) * 1e3,
                  "tok_per_s": 4 * (gen - 1) / res.decode_s},
        "checks": checks,
        "wall_s": time.perf_counter() - t_start,
    }
    print(json.dumps({"times": times}))
    print(json.dumps({"kernels": [{
        "name": "K1 flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "launches": launches,
        "max_abs_err": serve_err,
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
