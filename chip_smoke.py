#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for the float32 comparisons;
2. build: compile every kernel of the serve paths from ``src/repro_torch/
   kernels/csrc`` into ``build/kernels`` (one nvcc per source, all started
   together) and print the build seconds, ptxas's register lines and each
   variant's dynamic shared memory and blocks per SM;
3. kernels: hold each kernel (K1 flash attention, K2 SSD scan) against its
   plain PyTorch version on the card, every f32 case beside its bf16 twin
   (bf16 takes the tensor-core variant "tc", f32 the CUDA-core "fma"); at
   K2's serve shape, split its error into operand rounding (y written in
   f32; held to half the tolerance) and output rounding, beside the "fma"
   kernel and the tc kernel on bf16 operands only, on the same inputs;
4. serve: ``repro_torch.launch.serve`` on internlm2-1.8b at full width
   (24 layers, seeded random bf16 weights), batch 4, prompt 1024, 32 new
   tokens, flash prefill; count the kernel launches of that run by variant
   (24 tensor-core K1), check the logits, prefill->decode consistency, and
   flash against dot prefill;
5. serve, SSM: the same entry point on mamba2-1.3b at full width (48
   layers), batch 4, prompt 1024, 32 new tokens; every prefill layer's SSD
   goes through K2; count the launches by variant (48 tensor-core K2, none
   in decode), check the tokens, the logits and prefill->decode consistency
   (K2 prefill against the plain decode recurrence);
6. times: kernel (and, on the same inputs, its CUDA-core variant), plain
   version, library call and serve times, as JSON.  ``ms`` is the median of
   single calls, each timed alone (the host's launch work included);
   ``device_ms`` times calls enqueued back to back, which hides it;
7. cb: ElastiBench's own pipeline on the kernel-duet suite
   (``repro_torch.benchmarks.kernel_bench``).  Each duet's two versions run
   once on the card at the suite's default shapes and are held to each
   other (dot vs chunked attention 1e-5, the exact SSD recurrence vs
   ``ssd_chunked``, which is K2 "fma", 1e-4, unfused vs fused rms_norm
   1e-5); each duet then runs once directly, outside the engine, so that a
   failure raises here instead of becoming a failed invocation.  Then
   ``Pipeline(get_suite("kernels", device="cuda"))`` runs
   ``kernel_commits()`` with 12 calls per benchmark; every benchmark must
   come back with all 12 pairs, finite positive timings, one history
   record each, and K2 launched during the run.  The ``duets`` JSON line
   gives each benchmark's median times, change and CI;
8. cli: ElastiBench's command line (``repro_torch.cb.cli.main``) in this
   process, as a user starts it: ``--suite kernels`` with 12 calls per
   benchmark on the card must exit 0 and print one summary of one commit
   and 36 invocations, write one run record per benchmark to its history
   file, and launch K2; then one synthetic run (20 commits, lambda,
   selective_cached, seed 0), which must launch no kernel and print the
   summary line that the JAX package's command line prints for the same
   arguments (by its SHA-256).  The ``cli`` JSON line gives both summaries
   and the wall seconds of each;
9. bootstrap: the statistics engine's torch backend
   (``bootstrap_median_ci_batch(backend="torch", device="cuda")``) at
   k = 106 and k = 2,120 arrays of n = 45 diffs (the paper's suite at 15
   calls x 3 repeats, and twenty such commits in one batch), and on a
   ragged set with a NaN and an inf row, held to the NumPy backend at
   rtol 1e-5 / atol 1e-6; both backends timed (median of 7 synchronised
   calls, index matrices cached).  The ``bootstrap`` JSON line gives the
   largest deviation as a share of the tolerance and the times;
10. obs and service: the command line again, with observability on.
   (a) ``--suite kernels`` with ``--trace --metrics-out --slo
   --health-out`` on the card: one summary of 1 commit and 36
   invocations, K2 launched and K1 not, a valid trace whose only span is
   the commit's (its length, the engine's host wall time, is printed as
   a share of the run's wall time and held within 25%), the commit and
   selection counters, a health verdict and the exit code it implies;
   (b) the synthetic run of phase 8 with the same four flags: the same
   summary (obs changes nothing), and the trace size, verdict, alert and
   incident counts and exit code that the JAX command line gives;
   (c) the benchmarking service, host only: ``--jobs 16`` and a planned
   ``--deadline 900`` run, each summary line equal to the JAX command
   line's by SHA-256, and ``--suite kernels --jobs 2`` refused with exit
   2; (d) ``repro_torch.obs.watch`` on the timeout-storm scenario, whose
   health file must equal the JAX tool's by SHA-256.  Output files go to
   ``build/chip_smoke_obs/``; the ``obs_service`` JSON line gives each
   part's wall seconds, verdicts, exit codes and launches.

The last line of standard output is the device line
``{"ok": true, "device": {...}}``.  The script imports nothing of jax or
of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
SSM_SERVE_ARGS = ["--arch", "mamba2-1.3b", "--batch", "4", "--prompt-len", "1024",
                  "--gen", "32", "--seed", "0", "--device", "cuda"]
SSM_SERVE_SHAPE = dict(B=4, S=1024, H=64, G=1, P=64, N=128)     # mamba2-1.3b
GEN = 32
CB_CALLS = 12        # calls per benchmark of the phase 7 pipeline run
# the summary line that the JAX package's `python -m repro.cb.cli --commits 20
# --providers lambda --mode selective_cached --seed 0` prints, by SHA-256
CLI_SYNTHETIC_ARGS = ["--commits", "20", "--providers", "lambda", "--mode",
                      "selective_cached", "--seed", "0"]
CLI_SYNTHETIC_SHA256 = "803ea671580228c1287737deb5a4b768abfb38bf62026ee6656673f777e5a786"
# phase 10, each pinned from the JAX package's command line on a CPU:
# `python -m repro.cb.cli` + CLI_SYNTHETIC_ARGS + `--trace T --metrics-out M
# --slo --health-out H` records 2,040 trace events (metadata not counted),
# ends in verdict breach with 86 alerts and 3 incidents, and exits 4
OBS_SYNTHETIC = dict(trace_events=2040, verdict="breach", alerts=86, incidents=3, exit=4)
# the summary line of `python -m repro.cb.cli --jobs 16 --commits 6 --providers
# lambda --seed 0` (digest 2bd2468995d43fe2, 80 jobs), and that of `... --jobs 4
# --commits 4 --deadline 900 --seed 0` (digest c22b389ec35d714e, 12 jobs,
# planned lambda at 1,792 MB), by SHA-256
SERVICE_ARGS = ["--jobs", "16", "--commits", "6", "--providers", "lambda", "--seed", "0"]
SERVICE_SHA256 = "71983246eed066469fb4cf2941a1cd687c2e1187db22d02f850f077142de8d5c"
PLANNED_ARGS = ["--jobs", "4", "--commits", "4", "--deadline", "900", "--seed", "0"]
PLANNED_SHA256 = "6f5e7561465e0bde593763dc21733b5f352b59c88a90b43a1da255977805888b"
# the health file of `python -m repro.obs.watch --scenario timeout_storm --quick
# --expect-incident --out H` (verdict warn: 4 alerts, 2 anomalies, 1 incident)
WATCH_ARGS = ["--scenario", "timeout_storm", "--quick", "--expect-incident"]
WATCH_HEALTH_SHA256 = "2a0a7be8160afe14579321042836ab41943bfdadde1ff6d053e176a13f63b6c7"
BOOT_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_stats_batch.py's tolerance
# v1 against v2 of each duet, at the JAX tests' tolerances (tests/
# test_attention.py:28, tests/test_ssm.py:32; rms_norm in float32)
DUET_TOLERANCE = {"attention_dot_vs_chunked": 1e-5, "ssd_recurrence_vs_chunked": 1e-4,
                  "rmsnorm_fused_vs_unfused": 1e-5}


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
    """Build every kernel source at once (one nvcc each); seconds by name."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    names = ("flash_attention", "ssd_scan")
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build.build, name) for name in names}
        built = {name: f.result() for name, f in futures.items()}
    for name, (path, seconds) in built.items():
        log(f"built {path.relative_to(ROOT)} in {seconds:.1f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    return {name: seconds for name, (_, seconds) in built.items()}


def kernel_occupancy():
    """Dynamic shared memory and blocks per SM of each kernel variant, at
    the head dims of the serve shapes and at the largest ones taken."""
    from repro_torch.kernels import flash_attention, ssd_scan
    out = {}
    for key, query, dims in [("K1", flash_attention.occupancy, (128, 256)),
                             ("K2", ssd_scan.occupancy, (64, 128))]:
        for variant in ("tc", "fma"):
            for dim in dims:
                smem, blocks = query(variant, dim)
                out[f"{key} {variant} {'hd' if key == 'K1' else 'P'}={dim}"] = {
                    "smem_bytes": smem, "blocks_per_sm": blocks}
    for name, o in out.items():
        log(f"{name}: {o['smem_bytes']} B dynamic shared memory, "
            f"{o['blocks_per_sm']} blocks per SM")
    return out


def _qkv(B, Sq, Skv, H, K, hd, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda", dtype=torch.float32).to(dtype)
    return mk(B, H, Sq, hd), mk(B, K, Skv, hd), mk(B, K, Skv, hd)


def _agreement(a, b, tol):
    """(max |a - b|, the largest share of the tolerance atol = rtol = tol
    that an entry uses, entries out of tolerance).  The share tells output
    rounding apart from a real error: at |b| in [8, 16) one bf16 step is
    0.0625 yet only ~0.1 of the tolerance."""
    err = (a - b).abs()
    allowed = tol + tol * b.abs()
    return float(err.max()), float((err / allowed).max()), int((err > allowed).sum())


def check_k1():
    """K1 against its plain version on the card; returns the serve-shape
    error and its share of the tolerance."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_hmajor,
                                                     flash_attention_hmajor_plain, k1_variant)
    f32, bf16 = torch.float32, torch.bfloat16
    twins = []   # (name, shape, kwargs): each runs in f32 at 2e-5 and in bf16 at 3e-2
    for shape in [(2, 128, 128, 4, 2, 64), (1, 100, 100, 4, 4, 128), (2, 64, 64, 8, 2, 32),
                  (1, 128, 256, 4, 1, 64), (1, 257, 129, 2, 2, 256)]:
        for causal in (True, False):
            twins.append((f"{shape} causal={causal}", shape, dict(causal=causal)))
    for window in (8, 64, 200):
        twins.append((f"window={window}", (1, 128, 128, 4, 2, 64),
                      dict(causal=True, window=window)))
    twins.append(("ragged windowed GQA hd=96", (2, 300, 300, 8, 2, 96),
                  dict(causal=True, window=37)))
    twins.append(("ragged kv_valid hd=16", (2, 77, 200, 4, 2, 16),
                  dict(causal=False, kv_valid=150)))
    twins.append(("hd=72", (2, 100, 100, 4, 2, 72), dict(causal=True)))
    cases = []   # (name, shape, dtype, kwargs, tolerance)
    for name, shape, kw in twins:
        cases.append((f"f32 {name}", shape, f32, kw, 2e-5))
        cases.append((f"bf16 {name}", shape, bf16, kw, 3e-2))
    cases.append(("bf16 (1,128,128,4,4,64)", (1, 128, 128, 4, 4, 64), bf16,
                  dict(causal=True), 3e-2))
    s = SERVE_SHAPE
    serve_shape = (s["B"], s["Sq"], s["Skv"], s["H"], s["K"], s["hd"])
    cases.append(("bf16 serve shape", serve_shape, bf16, dict(causal=True), 3e-2))
    cases.append(("bf16 serve shape, peaked scores", serve_shape, bf16, dict(causal=True), 3e-2))

    serve = None
    for i, (name, (B, Sq, Skv, H, K, hd), dtype, kw, tol) in enumerate(cases):
        q, k, v = _qkv(B, Sq, Skv, H, K, hd, dtype, seed=i)
        if "peaked" in name:    # q, k at the std the serve model's init gives them
            q, k = (q.float() * 11.3).to(dtype), (k.float() * 11.3).to(dtype)
        variant = k1_variant(dtype, hd)
        before = flash_attention_hmajor.launches_by_variant[variant]
        out = flash_attention_hmajor(q, k, v, **kw)
        torch.cuda.synchronize()
        if flash_attention_hmajor.launches_by_variant[variant] != before + 1:
            fail(f"K1 {name}: the {variant} kernel was not the one launched")
        ref = flash_attention_hmajor_plain(q, k, v, **kw)
        if out.dtype != dtype or out.shape != q.shape:
            fail(f"K1 {name}: got {out.dtype} {tuple(out.shape)}")
        a = out.float()
        max_err, share, bad = _agreement(a, ref.float(), tol)
        log(f"K1 {name} [{variant}]: max_abs_err {max_err:.3e} (atol=rtol={tol}, "
            f"share {share:.3f}) {'ok' if bad == 0 else f'{bad} entries out of tolerance'}")
        if bad or not torch.isfinite(a).all():
            fail(f"K1 disagrees with its plain version on {name}")
        if name == "bf16 serve shape":
            serve = max_err, share
    return serve


def _reset_launches():
    """Set every kernel's launch counts to 0; returns the wrappers by kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_hmajor
    from repro_torch.kernels.ssd_scan import ssd_scan_hmajor
    wrappers = {"K1": flash_attention_hmajor, "K2": ssd_scan_hmajor}
    for w in wrappers.values():
        w.launches = 0
        w.launches_by_variant.update(tc=0, fma=0)
    return wrappers


def _serve_counted(args):
    """Drive ``serve.run(args)`` with every kernel's launch counts set to 0
    just before and read just after; returns (result, {kernel: launches},
    {kernel: {variant: launches}})."""
    from repro_torch.launch import serve
    wrappers = _reset_launches()
    res = serve.run(args)
    return (res, {k: w.launches for k, w in wrappers.items()},
            {k: dict(w.launches_by_variant) for k, w in wrappers.items()})


def _ssd_inputs(B, S, H, G, P, N, dtype, seed, dt_dtype=None, serve=False):
    """Head-major K2 inputs on the card.  The test cases draw them as
    tests/test_kernels.py:66-101 does; ``serve`` draws dt in the model's
    range (softplus of N(0,1) - 4.6) with A = -1 (``a_log`` = 0)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda", dtype=torch.float32)
    x = mk(B, H, S, P).to(dtype)
    if serve:
        dt = F.softplus(mk(B, H, S) - 4.6)
        A = -torch.ones(H, device="cuda")
    else:
        dt = F.softplus(mk(B, H, S))
        A = -torch.exp(mk(H) * 0.5)
    Bi = (mk(B, G, S, N) * 0.5).to(dtype)
    Ci = (mk(B, G, S, N) * 0.5).to(dtype)
    return x, dt.to(dt_dtype or torch.float32), A, Bi, Ci


def check_k2():
    """K2 against its plain version on the card (and against the step-by-step
    ``ssd_ref`` on the f32 cases); returns the serve-shape error with its
    share of the tolerance, and that error split by ``k2_rounding``."""
    import torch
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import (k2_variant, ssd_scan_hmajor,
                                              ssd_scan_hmajor_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []   # (name, (B, S, H, G, P, N), chunk, dtype, dt dtype, h0, tolerance)
    for name, shape, chunk, with_h0 in [
            ("(1,64,4,1,32,16)", (1, 64, 4, 1, 32, 16), 16, False),
            ("(2,37,4,2,16,32)", (2, 37, 4, 2, 16, 32), 16, False),
            ("(1,128,2,1,64,128)", (1, 128, 2, 1, 64, 128), 32, False),
            ("(1,96,8,4,16,16)", (1, 96, 8, 4, 16, 16), 48, False),
            ("(2,100,4,2,32,64) h0", (2, 100, 4, 2, 32, 64), 32, True),
            ("(1,200,2,1,128,64) h0", (1, 200, 2, 1, 128, 64), 64, True)]:
        cases.append((f"f32 {name} chunk={chunk}", shape, chunk, f32, f32, with_h0, 1e-4))
        cases.append((f"bf16 {name} chunk={chunk}", shape, chunk, bf16, f32, with_h0, 5e-2))
    cases.append(("bf16 (1,64,2,1,32,16) dt bf16", (1, 64, 2, 1, 32, 16), 16, bf16, bf16,
                  False, 5e-2))
    s = SSM_SERVE_SHAPE
    cases.append(("bf16 serve shape, dt f32", (s["B"], s["S"], s["H"], s["G"], s["P"], s["N"]),
                  256, bf16, f32, False, 5e-2))

    serve = rounding = None
    for i, (name, (B, S, H, G, P, N), chunk, dtype, dt_dtype, with_h0, tol) in enumerate(cases):
        x, dt, A, Bi, Ci = _ssd_inputs(B, S, H, G, P, N, dtype, seed=100 + i,
                                       dt_dtype=dt_dtype, serve="serve" in name)
        h0 = None
        if with_h0:
            g = torch.Generator(device="cuda").manual_seed(200 + i)
            h0 = torch.randn((B, H, P, N), generator=g, device="cuda") * 0.5
        variant = k2_variant(dtype, P, N)
        before = ssd_scan_hmajor.launches_by_variant[variant]
        y, st = ssd_scan_hmajor(x, dt, A, Bi, Ci, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        if ssd_scan_hmajor.launches_by_variant[variant] != before + 1:
            fail(f"K2 {name}: the {variant} kernel was not the one launched")
        refs = {"plain": ssd_scan_hmajor_plain(x, dt, A, Bi, Ci, chunk=chunk, h0=h0)}
        if dtype == f32:
            refs["ssd_ref"] = ssd_ref(x, dt, A, Bi, Ci, h0=h0)
        if y.dtype != dtype or y.shape != x.shape or st.dtype != f32 or st.shape != (B, H, P, N):
            fail(f"K2 {name}: got y {y.dtype} {tuple(y.shape)}, state {st.dtype} "
                 f"{tuple(st.shape)}")
        if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
            fail(f"K2 {name}: output is not finite")
        for ref_name, (yr, sr) in refs.items():
            ey = _agreement(y.float(), yr.float(), tol)
            es = _agreement(st, sr, tol)
            bad = ey[2] + es[2]
            log(f"K2 {name} [{variant}] vs {ref_name}: max_abs_err y {ey[0]:.3e} state "
                f"{es[0]:.3e} (atol=rtol={tol}, share y {ey[1]:.3f} state {es[1]:.3f}) "
                f"{'ok' if bad == 0 else f'{bad} entries out of tolerance'}")
            if bad:
                fail(f"K2 disagrees with {ref_name} on {name}")
            if "serve" in name:
                serve = max(ey[0], es[0]), max(ey[1], es[1])
        if "serve" in name:
            rounding = k2_rounding(x, dt, A, Bi, Ci, y, tol)
    return serve, rounding


def k2_rounding(x, dt, A, Bi, Ci, y_tc, tol):
    """Where K2's bf16 serve-shape error comes from.  y is stored in bf16 on
    both sides, so the error against the plain version holds the operand
    rounding of the tensor-core products and, at an entry where the two
    unrounded values straddle a rounding boundary, one bf16 step of output
    rounding.  The "tc" kernel writing y in f32 gives the first alone; the
    "fma" kernel (fp32 products) on the same inputs gives the floor that
    output rounding sets.  "tc" runs att @ x and C @ state^T on tf32
    operands; the same kernel with every product on bf16 operands
    (``tf32=False``) is measured beside it."""
    import torch
    from repro_torch.kernels import ssd_scan as ks
    ref32, _ = ks.ssd_scan_hmajor_plain(x.float(), dt, A, Bi.float(), Ci.float(), chunk=256)
    ref = ref32.to(torch.bfloat16).float()
    y_pre, _ = ks._launch(x, dt, A, Bi, Ci, None, "tc", torch.float32)
    y_fma, _ = ks._launch(x, dt, A, Bi, Ci, None, "fma", torch.bfloat16)
    y_b16, _ = ks._launch(x, dt, A, Bi, Ci, None, "tc", torch.bfloat16, tf32=False)
    y_b16_pre, _ = ks._launch(x, dt, A, Bi, Ci, None, "tc", torch.float32, tf32=False)
    torch.cuda.synchronize()
    out = {"max_abs_y": float(ref32.abs().max()),
           "tc_f32_y_rounds_to_tc_y": bool(torch.equal(y_pre.to(torch.bfloat16), y_tc))}
    for label, got, against in [("tc_vs_plain", y_tc, ref), ("fma_vs_plain", y_fma, ref),
                                ("tc_f32_y_vs_plain_f32", y_pre, ref32),
                                ("tc_vs_plain_f32", y_tc, ref32),
                                ("fma_vs_plain_f32", y_fma, ref32),
                                ("tc_bf16_operands_vs_plain", y_b16, ref),
                                ("tc_bf16_operands_f32_y_vs_plain_f32", y_b16_pre, ref32)]:
        err = (got.float() - against).abs()
        i = int(err.argmax())
        out[label] = {"max_abs_err": float(err.max()),
                      "abs_y_there": float(against.flatten()[i].abs()),
                      "tolerance_share": float((err / (tol + tol * against.abs())).max())}
    log(f"K2 serve shape, rounding: {json.dumps(out)}")
    if not out["tc_f32_y_rounds_to_tc_y"]:
        fail("K2 tc with y in f32 does not round to the bf16 y of the same kernel")
    if not out["tc_f32_y_vs_plain_f32"]["max_abs_err"] <= tol / 2:
        fail(f"K2 tc's operand rounding alone is above half the tolerance ({tol / 2}) at "
             "the serve shape")
    return out


def run_serve():
    """The port's main path, with the kernel launch counts read around it."""
    res, counts, by_variant = _serve_counted(SERVE_ARGS)
    launches = counts["K1"]
    cfg = res.lm.cfg
    log(f"serve: {cfg.name} L={cfg.num_layers} D={cfg.d_model} H={cfg.num_heads} "
        f"K={cfg.num_kv_heads} hd={cfg.head_dim} F={cfg.d_ff} V={cfg.vocab_size}: "
        f"prefill {res.prefill_s*1e3:.1f} ms, decode "
        f"{res.decode_s/(GEN-1)*1e3:.2f} ms/token, launches {counts} {by_variant}")
    if (launches != cfg.num_layers or by_variant["K1"]["tc"] != cfg.num_layers
            or counts["K2"] != 0):
        fail(f"launches {counts} {by_variant} in the internlm2 serve run, want K1 "
             f"{cfg.num_layers} on the tensor cores (one per layer of the prefill) and K2 0")
    return res, launches


def run_ssm_serve():
    """The SSM serve path: K2 once per prefill layer, none in decode."""
    res, counts, by_variant = _serve_counted(SSM_SERVE_ARGS)
    launches = counts["K2"]
    cfg = res.lm.cfg
    s = cfg.ssm
    log(f"serve: {cfg.name} L={cfg.num_layers} D={cfg.d_model} "
        f"d_inner={s.d_inner(cfg.d_model)} heads={s.n_heads(cfg.d_model)} P={s.head_dim} "
        f"N={s.d_state} G={s.n_groups} V={cfg.vocab_size}: prefill "
        f"{res.prefill_s*1e3:.1f} ms, decode {res.decode_s/(GEN-1)*1e3:.2f} ms/token, "
        f"launches {counts} {by_variant}")
    if (launches != cfg.num_layers or by_variant["K2"]["tc"] != cfg.num_layers
            or counts["K1"] != 0):
        fail(f"launches {counts} {by_variant} in the mamba2 serve run, want K2 "
             f"{cfg.num_layers} on the tensor cores (one per layer of the prefill, none in "
             "decode) and K1 0")
    return res, launches


def _consistency(lm, prompts, nxt, kv_dtype):
    """rel. max difference of the last logits: full forward against prefill
    followed by one decode step (tests/test_models_smoke.py:58-93)."""
    import torch
    from repro_torch.launch.serve import grow_cache
    cfg = lm.cfg
    S = prompts.shape[1]
    full = lm.forward(torch.cat([prompts, nxt], 1), mode="train")["logits"]
    pf = lm.forward(prompts, mode="prefill", kv_dtype=kv_dtype)
    cache = grow_cache(cfg, pf["cache"], 2 * S)
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


def _check_tokens(res):
    import torch
    cfg = res.lm.cfg
    if (res.tokens.shape != (4, GEN) or res.tokens.min() < 0
            or res.tokens.max() >= cfg.vocab_size):
        fail(f"{cfg.name} serve tokens: shape {res.tokens.shape}, range "
             f"[{res.tokens.min()}, {res.tokens.max()}]")
    if not torch.isfinite(res.prefill_logits[..., :cfg.vocab_size].float()).all():
        fail(f"{cfg.name} prefill logits are not finite")


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
    _check_tokens(res)

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


def check_ssm_serve(res, check_layers=1):
    """Checks of the mamba2 serve run's output.  Prefill runs K2 and decode
    the plain recurrence (``ssd_decode_step``), so prefill->decode
    consistency is the model-level check of K2: held at rel < 0.08 on the
    same width cut to ``check_layers`` layers, in bf16 and in f32, and
    reported at full depth."""
    import torch
    from repro_torch.models.lm import LM
    lm, prompts = res.lm, res.prompts
    cfg = lm.cfg
    _check_tokens(res)
    g = torch.Generator(device="cuda").manual_seed(5)
    nxt = torch.randint(0, cfg.vocab_size, (prompts.shape[0], 1), generator=g, device="cuda")
    full, cut = {}, {}
    with torch.inference_mode():
        full["bf16_prefill_decode_rel"] = _consistency(lm, prompts, nxt, "bfloat16")
        short = LM(dataclasses.replace(cfg, num_layers=check_layers), device="cuda", seed=0)
        cut["bf16_prefill_decode_rel"] = _consistency(short, prompts, nxt, "bfloat16")
        short.float()
        cut["f32_prefill_decode_rel"] = _consistency(short, prompts, nxt, "float32")
        del short
    log(f"mamba2 serve checks at {cfg.num_layers} layers (reported): {json.dumps(full)}")
    log(f"mamba2 serve checks at {check_layers} layers (held): {json.dumps(cut)}")
    for key in ("bf16_prefill_decode_rel", "f32_prefill_decode_rel"):
        if not cut[key] < 0.08:
            fail(f"mamba2 {key}={cut[key]:.4f} at {check_layers} layers (limit 0.08)")
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
    """Median over n single calls of CUDA-event time, in ms.  Each call
    starts on an idle card, so the host's work to launch it is counted."""
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


def _device_ms(fn, reps=7, per_rep=10, warmup=3):
    """Device time of one call, in ms: CUDA events around ``per_rep`` calls
    enqueued back to back, so that the host's work to launch each call
    overlaps the card's work on the one before, divided by ``per_rep``; the
    median of ``reps`` such runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(per_rep):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / per_rep)
    return statistics.median(times)


def time_k1():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_launch, flash_attention_hmajor,
                                                     flash_attention_hmajor_plain)
    s = SERVE_SHAPE
    B, Sq, Skv, H, K, hd = s["B"], s["Sq"], s["Skv"], s["H"], s["K"], s["hd"]
    q, k, v = _qkv(B, Sq, Skv, H, K, hd, torch.bfloat16, seed=99)
    kernel = lambda: flash_attention_hmajor(q, k, v, causal=True)
    library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    kernel_ms, device_ms = _time_ms(kernel), _device_ms(kernel)
    fma_ms = _time_ms(lambda: _launch(q, k, v, "fma", causal=True, window=0, kv_valid=None,
                                      softmax_scale=None))
    plain_ms = _time_ms(lambda: flash_attention_hmajor_plain(q, k, v, causal=True))
    library_ms, library_device_ms = _time_ms(library), _device_ms(library)
    # least time for the same work: the causal (q, k) pairs only (Sq == Skv here)
    pairs = Sq * (Sq + 1) // 2
    flops = 4 * hd * pairs * B * H                      # q.k and p.v, 2 flops per MAC
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(ms=kernel_ms, device_ms=device_ms, fma_ms=fma_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_device_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def time_k2():
    from repro_torch.kernels.ssd_scan import _launch, ssd_scan_hmajor, ssd_scan_hmajor_plain
    import torch
    s = SSM_SERVE_SHAPE
    B, S, H, G, P, N = s["B"], s["S"], s["H"], s["G"], s["P"], s["N"]
    x, dt, A, Bi, Ci = _ssd_inputs(B, S, H, G, P, N, torch.bfloat16, seed=98, serve=True)
    kernel = lambda: ssd_scan_hmajor(x, dt, A, Bi, Ci)
    kernel_ms, device_ms = _time_ms(kernel), _device_ms(kernel)
    fma_ms = _time_ms(lambda: _launch(x, dt, A, Bi, Ci, None, "fma", torch.bfloat16))
    bf16_ops = lambda: _launch(x, dt, A, Bi, Ci, None, "tc", torch.bfloat16, tf32=False)
    bf16_operands_ms, bf16_operands_device_ms = _time_ms(bf16_ops), _device_ms(bf16_ops)
    plain_ms = _time_ms(lambda: ssd_scan_hmajor_plain(x, dt, A, Bi, Ci, chunk=256))
    # least time for the same work: bytes read and written once; operations
    # of the chunk-256 block decomposition (C B^T once per group and chunk,
    # the causal half of att @ x, C @ state^T and the state update)
    Q = 256
    nc = -(-S // Q)
    flops = (2 * Q * Q * N * B * G * nc                    # C B^T
             + 2 * (Q * (Q + 1) // 2) * P * B * H * nc     # att @ x, causal half
             + 2 * Q * N * P * B * H * nc                  # C @ state^T
             + 2 * P * N * Q * B * H * nc)                 # state update
    nbytes = (x.numel() * x.element_size() * 2             # x in, y out
              + dt.numel() * dt.element_size() + A.numel() * A.element_size()
              + (Bi.numel() + Ci.numel()) * Bi.element_size()
              + B * H * P * N * 4)                          # final state, f32
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(ms=kernel_ms, device_ms=device_ms, fma_ms=fma_ms, plain_ms=plain_ms,
                library_ms=None, library_device_ms=None, bf16_operands_ms=bf16_operands_ms,
                bf16_operands_device_ms=bf16_operands_device_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def _device_per_call(fn, inputs):
    """(device work items, device ms) of one warm call of ``fn``, summed
    over the CUDA events of a torch.profiler trace; (None, None) where the
    trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*inputs)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, None
    return sum(e.count for e in events), sum(e.self_device_time_total for e in events) / 1e3


def check_duets():
    """Each duet's two versions once on the card at the suite's default
    shapes, held to each other at the JAX tests' tolerances, and one more
    call of each under the profiler; returns the errors and the device work
    of a call, by duet."""
    import torch
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.kernels.ssd_scan import ssd_scan_hmajor
    out = {}
    for name, v1, v2, draw, _ in kb.DUETS:
        inputs = draw(device=torch.device("cuda"))
        fma = ssd_scan_hmajor.launches_by_variant["fma"]
        a, b = v1(*inputs), v2(*inputs)
        torch.cuda.synchronize()
        ssd = name == "ssd_recurrence_vs_chunked"
        if ssd:
            a = a.movedim(1, 2)     # the recurrence's y is head-major
        if ssd and ssd_scan_hmajor.launches_by_variant["fma"] != fma + 1:
            fail(f"duet {name}: ssd_chunked did not launch K2 fma once")
        if a.shape != b.shape or not (a.is_cuda and b.is_cuda):
            fail(f"duet {name}: versions give {tuple(a.shape)} on {a.device} and "
                 f"{tuple(b.shape)} on {b.device}")
        tol = DUET_TOLERANCE[name]
        max_err, share, bad = _agreement(a.float(), b.float(), tol)
        log(f"duet {name}: v1 vs v2 max_abs_err {max_err:.3e} (atol=rtol={tol}, share "
            f"{share:.3f}) {'ok' if bad == 0 else f'{bad} entries out of tolerance'}")
        if bad or not torch.isfinite(b).all():
            fail(f"duet {name}: the two versions disagree")
        out[name] = {"max_abs_err": max_err, "tolerance": tol, "tolerance_share": share}
        for side, fn in (("v1", v1), ("v2", v2)):
            n, ms = _device_per_call(fn, inputs)
            out[name].update({f"{side}_device_items": n, f"{side}_device_ms": ms})
        log(f"duet {name}: device work per call {json.dumps(out[name])}")
    return out


def run_cb():
    """The paper's pipeline on the kernel-duet suite, on the card.  Returns
    the duets line and the launches of each kernel during the pipeline run."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.cb import Pipeline, PipelineConfig, get_suite
    from repro_torch.cb.history import SOURCE_RUN
    suite = get_suite("kernels", device="cuda")
    # the engine times each duet on a worker thread, where K2 launches on the
    # thread's current stream: it must be the default stream there
    with ThreadPoolExecutor(1) as pool:
        worker_stream = pool.submit(lambda: torch.cuda.current_stream().cuda_stream).result()
    if worker_stream != torch.cuda.default_stream().cuda_stream:
        fail("a worker thread's current CUDA stream is not the default stream")
    for name, duet in suite._build().items():      # outside the engine: failures raise
        v1s, v2s = duet.run_pair(("v1", "v2"))
        log(f"duet {name} once, directly: v1 {v1s * 1e3:.4f} ms, v2 {v2s * 1e3:.4f} ms")
    reports = []      # the suite's run results: their engine reports hold the pairs
    suite_run = suite.run
    suite.run = lambda *a, **kw: reports.append(suite_run(*a, **kw)) or reports[-1]
    pipe = Pipeline(suite, PipelineConfig(
        suite="kernels", provider="local", mode="selective", n_calls=CB_CALLS,
        repeats_per_call=1, parallelism=1, min_results=10))
    commits = kb.kernel_commits()
    wrappers = _reset_launches()
    t0 = time.perf_counter()
    rep = pipe.run_stream(commits)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    by_variant = {k: dict(w.launches_by_variant) for k, w in wrappers.items()}

    names = suite.benchmark_names()
    if len(rep.commits) != 1:
        fail(f"pipeline: {len(rep.commits)} commit runs, want 1")
    run = rep.commits[0]
    if sorted(run.ran) != names or len(reports) != 1:
        fail(f"pipeline ran {run.ran} in {len(reports)} suite runs, want {names} in one")
    report = reports[0].report
    if report.failed_benchmarks:
        fail(f"pipeline: failed benchmarks {report.failed_benchmarks}")
    if sorted(run.changes) != names or any(c.n_pairs != CB_CALLS for c in run.changes.values()):
        fail(f"pipeline: pairs {({b: c.n_pairs for b, c in run.changes.items()})}, "
             f"want {CB_CALLS} for each of {names}")
    if run.invocations != CB_CALLS * len(run.ran):
        fail(f"pipeline: {run.invocations} invocations, want {CB_CALLS * len(run.ran)}")
    recs = [r for r in pipe.history.records() if r.source == SOURCE_RUN]
    if (sorted(r.benchmark for r in recs) != names
            or any(r.invocations != CB_CALLS or not r.billed_seconds > 0 for r in recs)):
        fail(f"history: {[(r.benchmark, r.invocations, r.billed_seconds) for r in recs]}")
    times = {b: ([], []) for b in names}
    for p in report.pairs:
        times[p.benchmark][0].append(p.v1_seconds)
        times[p.benchmark][1].append(p.v2_seconds)
    if not all(math.isfinite(t) and t > 0 for v in times.values() for side in v for t in side):
        fail("pipeline: a duet timing is not finite and positive")
    if by_variant["K2"]["fma"] < 1 or launches["K1"] != 0:
        fail(f"pipeline: launches {launches} {by_variant}, want K2 fma at least once "
             "(the SSD duet's chunked side) and K1 none")
    duets = {b: {"v1_median_s": statistics.median(times[b][0]),
                 "v2_median_s": statistics.median(times[b][1]),
                 "median_diff_pct": c.median_diff_pct, "ci": [c.ci_low, c.ci_high],
                 "changed": c.changed, "n": c.n_pairs}
             for b, c in sorted(run.changes.items())}
    line = {**duets, "wall_s": wall, "engine_wall_s": report.wall_seconds,
            "invocations": run.invocations, "k2_launches": launches["K2"],
            "k2_launches_by_variant": by_variant["K2"]}
    log(f"pipeline: {run.invocations} invocations in {wall:.2f} s, launches {launches} "
        f"{by_variant}")
    return line, launches


def _sha256(text):
    import hashlib
    return hashlib.sha256(text.encode()).hexdigest()


def _cli(argv):
    """``repro_torch.cb.cli.main(argv)`` in this process: (exit code, stdout
    lines, wall s, {kernel: launches}), the counts set to 0 just before.
    The command line installs its observability context and leaves it in
    place; it is removed after the run, so that the next run starts clean."""
    import contextlib
    import io
    from repro_torch.cb import cli
    from repro_torch.obs import set_obs
    wrappers = _reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    wall = time.perf_counter() - t0
    set_obs(None)
    return (code, buf.getvalue().splitlines(), wall,
            {k: w.launches for k, w in wrappers.items()})


def run_cli():
    """Phase 8: the command line, on the kernel suite and on a synthetic
    stream.  Returns the cli line and the kernel run's launches."""
    import shutil
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.cb.history import SOURCE_RUN, HistoryStore
    from repro_torch.faas.engine_vec import get_fallback_log, reset_fallback_log
    out = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    history = out / "history.jsonl"
    reset_fallback_log()
    code, lines, wall, launches = _cli(
        ["--suite", "kernels", "--n-calls", str(CB_CALLS), "--repeats", "1",
         "--parallelism", "1", "--history", str(history)])
    fallbacks = sorted(set(get_fallback_log()))
    summaries = [json.loads(line) for line in lines if line.startswith("{")]
    names = sorted(name for name, *_ in kb.DUETS)
    if code != 0:
        fail(f"cli --suite kernels: exit code {code}")
    if (len(summaries) != 1 or summaries[0]["commits"] != 1
            or summaries[0]["invocations"] != CB_CALLS * len(names)):
        fail(f"cli --suite kernels: summaries {summaries}, want one of 1 commit and "
             f"{CB_CALLS * len(names)} invocations")
    records = HistoryStore(str(history)).records()
    runs = [r for r in records if r.source == SOURCE_RUN]
    if sorted(r.benchmark for r in runs) != names or any(r.invocations != CB_CALLS
                                                         for r in runs):
        fail(f"cli --suite kernels: history {[(r.benchmark, r.invocations) for r in runs]}")
    if launches["K2"] < 1 or launches["K1"] != 0:
        fail(f"cli --suite kernels: launches {launches}, want K2 at least once and K1 none")
    log(f"cli --suite kernels: exit 0 in {wall:.2f} s, launches {launches}, "
        f"engine fallbacks {fallbacks}")

    code, lines, syn_wall, syn_launches = _cli(CLI_SYNTHETIC_ARGS)
    syn = [line for line in lines if line.startswith("{")]
    if code != 0 or len(syn) != 1 or any(syn_launches.values()):
        fail(f"cli synthetic: exit code {code}, {len(syn)} summaries, launches {syn_launches}")
    digest = _sha256(syn[0])
    if digest != CLI_SYNTHETIC_SHA256:
        fail(f"cli synthetic: summary {syn[0]} differs from the JAX package's "
             f"(sha256 {digest})")
    log(f"cli synthetic: exit 0 in {syn_wall:.2f} s, summary equals the JAX package's")
    return {"kernels": summaries[0], "kernels_wall_s": wall, "k2_launches": launches["K2"],
            "engine_fallbacks": fallbacks, "history_records": len(records),
            "synthetic": json.loads(syn[0]), "synthetic_wall_s": syn_wall}, launches


def _obs_files(out, tag):
    """The four observability flags, writing into ``out`` under ``tag``."""
    paths = {k: out / f"{tag}.{k}.json" for k in ("trace", "metrics", "health")}
    return paths, ["--trace", str(paths["trace"]), "--metrics-out", str(paths["metrics"]),
                   "--slo", "--health-out", str(paths["health"])]


def _read_obs(paths):
    """(trace events without metadata, trace schema errors, metrics
    snapshot, health verdict) of one observed run."""
    from repro_torch.obs import validate_chrome_trace
    trace = json.loads(paths["trace"].read_text())
    events = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    return (events, validate_chrome_trace(trace), json.loads(paths["metrics"].read_text()),
            json.loads(paths["health"].read_text()))


def run_obs_service(kernels_off_wall):
    """Phase 10: the command line with observability on (the kernel suite on
    the card, the synthetic run on the host), the benchmarking service and
    the watch tool.  Returns the obs_service line and the launches of (a)."""
    import contextlib
    import io
    import shutil
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.cb.cli import EXIT_BREACH, EXIT_INFEASIBLE, resolve_exit_code
    from repro_torch.obs import watch
    out = ROOT / "build" / "chip_smoke_obs"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    line = {}

    # (a) the observed kernel suite on the card
    paths, flags = _obs_files(out, "kernels")
    code, lines, wall, launches = _cli(
        ["--suite", "kernels", "--n-calls", str(CB_CALLS), "--repeats", "1",
         "--parallelism", "1"] + flags)
    summaries = [json.loads(x) for x in lines if x.startswith("{")]
    n_inv = CB_CALLS * len(kb.DUETS)
    if (len(summaries) != 1 or summaries[0]["commits"] != 1
            or summaries[0]["invocations"] != n_inv):
        fail(f"obs --suite kernels: summaries {summaries}, want one of 1 commit and "
             f"{n_inv} invocations")
    if launches["K2"] < 1 or launches["K1"] != 0:
        fail(f"obs --suite kernels: launches {launches}, want K2 at least once and K1 none")
    events, errors, metrics, health = _read_obs(paths)
    if errors or [(e["ph"], e.get("cat")) for e in events] != [("X", "commit")]:
        fail(f"obs --suite kernels: trace errors {errors}, events "
             f"{[(e['ph'], e.get('cat'), e['name']) for e in events]}, want one commit span")
    span_share = events[0]["dur"] / 1e6 / wall
    counters = {c["name"]: (c["labels"], c["value"]) for c in metrics["counters"]}
    want = {"cb.commits": ({"provider": "local"}, 1.0),
            "cb.benchmarks_selected": ({"provider": "local"}, float(len(kb.DUETS)))}
    if any(counters.get(k) != v for k, v in want.items()):
        fail(f"obs --suite kernels: counters {counters}, want {want}")
    verdict = health["verdict"]
    want_code = resolve_exit_code(0, EXIT_BREACH if verdict == "breach" else 0)
    if verdict not in ("healthy", "warn", "breach") or code != want_code:
        fail(f"obs --suite kernels: verdict {verdict!r}, exit code {code} (want {want_code})")
    log(f"obs --suite kernels: exit {code} in {wall:.2f} s (phase 8, obs off: "
        f"{kernels_off_wall:.2f} s), commit span {span_share:.3f} of the wall, verdict "
        f"{verdict}, launches {launches}")
    if abs(span_share - 1.0) > 0.25:
        fail(f"obs --suite kernels: the commit span is {span_share:.3f} of the run's wall time")
    line["kernels"] = {"wall_s": wall, "obs_off_wall_s": kernels_off_wall,
                       "commit_span_s": events[0]["dur"] / 1e6, "span_share": span_share,
                       "verdict": verdict, "alerts": len(health["alerts"]), "exit": code,
                       "launches": launches, "counters": {k: v[1] for k, v in counters.items()},
                       "summary": summaries[0]}

    # (b) the observed synthetic run: obs changes no number
    paths, flags = _obs_files(out, "synthetic")
    code, lines, wall, launches = _cli(CLI_SYNTHETIC_ARGS + flags)
    syn = [x for x in lines if x.startswith("{")]
    events, errors, _, health = _read_obs(paths)
    got = dict(trace_events=len(events), verdict=health["verdict"],
               alerts=len(health["alerts"]), incidents=len(health["incidents"]), exit=code)
    if len(syn) != 1 or _sha256(syn[0]) != CLI_SYNTHETIC_SHA256:
        fail(f"obs synthetic: summaries {syn} differ from the JAX package's")
    if got != OBS_SYNTHETIC or errors or any(launches.values()):
        fail(f"obs synthetic: {got}, trace errors {errors[:3]}, launches {launches}; "
             f"want {OBS_SYNTHETIC} and no launch")
    log(f"obs synthetic: exit {code} in {wall:.2f} s, summary and {json.dumps(got)} equal "
        "the JAX package's")
    line["synthetic"] = {"wall_s": wall, **got, "launches": launches}

    # (c) the benchmarking service (host only)
    for name, argv, digest in (("service", SERVICE_ARGS, SERVICE_SHA256),
                               ("planned", PLANNED_ARGS, PLANNED_SHA256)):
        code, lines, wall, launches = _cli(argv)
        summ = [x for x in lines if x.startswith("{")]
        if code != 0 or len(summ) != 1 or _sha256(summ[0]) != digest or any(launches.values()):
            fail(f"{name}: exit code {code}, summaries {summ}, launches {launches}; want exit "
                 "0, no launch and the JAX package's summary line")
        s_ = json.loads(summ[0])
        log(f"{name}: exit 0 in {wall:.2f} s, {s_['jobs']} jobs, {s_['invocations']} "
            f"invocations, ${s_['cost_usd']}, digest {s_['digest']}: equals the JAX package's")
        line[name] = {"wall_s": wall, "exit": code, "launches": launches,
                      **{k: s_[k] for k in ("jobs", "invocations", "cost_usd", "digest",
                                            "planned_provider", "planned_memory_mb") if k in s_}}
    code, lines, wall, launches = _cli(["--suite", "kernels", "--jobs", "2"])
    if code != EXIT_INFEASIBLE or any(launches.values()):
        fail(f"--suite kernels --jobs 2: exit code {code}, launches {launches}; want "
             f"{EXIT_INFEASIBLE} and no launch")
    line["kernels_service_refused"] = {"exit": code, "wall_s": wall}

    # (d) the watch tool on the timeout-storm scenario
    health_path = out / "watch.health.json"
    wrappers = _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        code = watch.main(WATCH_ARGS + ["--out", str(health_path)])
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    text = health_path.read_text()
    health = json.loads(text)
    if code != 0 or _sha256(text) != WATCH_HEALTH_SHA256 or any(launches.values()):
        fail(f"watch: exit code {code}, health sha256 {_sha256(text)}, launches {launches}; "
             "want exit 0, no launch and the JAX tool's health file")
    line["watch"] = {"wall_s": wall, "exit": code, "verdict": health["verdict"],
                     "alerts": len(health["alerts"]), "anomalies": len(health["anomalies"]),
                     "incidents": len(health["incidents"]), "launches": launches}
    log(f"watch timeout_storm: exit 0 in {wall:.2f} s, {json.dumps(line['watch'])}: health "
        "file equals the JAX tool's")
    return line, line["kernels"]["launches"]


def _boot_sets():
    """The phase 9 inputs, drawn from a seed: relative diffs in percent."""
    import numpy as np
    rng = np.random.default_rng(0)
    ragged = [rng.normal(2.0, 5.0, n) for n in (45, 45, 44, 30, 12, 45, 0)]
    ragged[1][7], ragged[2][0] = np.nan, np.inf
    return {"k106_n45": [rng.normal(2.0, 5.0, 45) for _ in range(106)],
            "k2120_n45": [rng.normal(2.0, 5.0, 45) for _ in range(2120)],
            "ragged_nan_inf": ragged}


def _median_call_ms(fn, n=7):
    import torch
    fn()                        # index matrices cached, card warm
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_bootstrap():
    """Phase 9: the torch statistics backend on the card against NumPy."""
    import numpy as np
    from repro_torch.core import stats
    from repro_torch.kernels import stats_boot
    n_boot, confidence = 1000, 0.99
    rows_per_chunk = stats_boot._GATHER_BYTES // (n_boot * 45 * 4)
    out = {}
    for name, arrays in _boot_sets().items():
        def call(backend):
            return stats.bootstrap_median_ci_batch(arrays, confidence=confidence,
                                                   n_boot=n_boot, seed=0, backend=backend,
                                                   device="cuda")
        got, ref = call("torch"), call("numpy")
        share = 0.0
        for g, r in zip(got, ref):
            if not np.array_equal(np.isnan(g), np.isnan(r)) or not np.array_equal(
                    g[np.isinf(r)], r[np.isinf(r)]):
                fail(f"bootstrap {name}: non-finite entries differ from NumPy's")
            ok = np.isfinite(r)
            dev = np.abs(g[ok] - r[ok]) / (BOOT_TOL["atol"] + BOOT_TOL["rtol"] * np.abs(r[ok]))
            share = max(share, float(dev.max(initial=0.0)))
        if share > 1.0:
            fail(f"bootstrap {name}: torch backend {share:.3f} of the tolerance off NumPy's")
        out[name] = {"k": len(arrays), "max_tolerance_share": share,
                     "torch_ms": _median_call_ms(lambda: call("torch")),
                     "numpy_ms": _median_call_ms(lambda: call("numpy"))}
        if name.startswith("k"):
            out[name]["gather_chunks"] = -(-len(arrays) // rows_per_chunk)
        log(f"bootstrap {name}: {json.dumps(out[name])}")
    return out


def _serve_times(res, prefill_warm_ms, checks):
    cfg = res.lm.cfg
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": 4, "prompt_len": 1024,
            "gen": GEN, "prefill_ms": res.prefill_s * 1e3,
            "prefill_warm_ms": prefill_warm_ms,
            "decode_ms_per_token": res.decode_s / (GEN - 1) * 1e3,
            "tok_per_s": 4 * (GEN - 1) / res.decode_s, "checks": checks}


_TIME_KEYS = ("ms", "device_ms", "fma_ms", "plain_ms", "library_ms", "library_device_ms",
              "bound_ms", "bound_by")


def _kernel_line(name, source, replaces, launches, duet_launches, cli_launches,
                 obs_launches, max_abs_err, t):
    """One kernel of the serve paths: its tensor-core variant, which the bf16
    main path runs; ``fma_ms`` is its CUDA-core variant on the same inputs.
    ``launches`` counts the serve run, ``duet_launches`` the pipeline run of
    phase 7, ``cli_launches`` the command line's kernel-suite run of phase 8,
    ``obs_launches`` the observed kernel-suite run of phase 10."""
    return {"name": name, "route": "cuda", "variant": "tc", "source": source,
            "replaces": replaces, "launches": launches, "duet_launches": duet_launches,
            "cli_launches": cli_launches, "obs_launches": obs_launches,
            "max_abs_err": max_abs_err, **{k: t[k] for k in _TIME_KEYS}}


def main():
    t_start = time.perf_counter()
    card = check_device()
    sys.path.insert(0, str(SRC))
    import torch

    build_s = build_kernels()
    occupancy = kernel_occupancy()
    k1_err, k1_share = check_k1()
    (k2_err, k2_share), k2_rounding_split = check_k2()

    res, k1_launches = run_serve()
    checks = check_serve(res)
    serve = _serve_times(res, time_prefill(res.lm, res.prompts), checks)
    del res
    k1 = time_k1()

    torch.cuda.empty_cache()
    res, k2_launches = run_ssm_serve()
    checks = check_ssm_serve(res)
    ssm_serve = _serve_times(res, time_prefill(res.lm, res.prompts), checks)
    del res
    k2 = time_k2()

    t_cb = time.perf_counter()
    duet_checks = check_duets()
    duets, duet_launches = run_cb()
    for name, c in duet_checks.items():
        for side in ("v1", "v2"):
            ms = c[f"{side}_device_ms"]
            duets[name][f"{side}_device_share"] = (
                None if ms is None else ms / (duets[name][f"{side}_median_s"] * 1e3))
    print(json.dumps({"duets": {**duets, "checks": duet_checks,
                                "phase_s": time.perf_counter() - t_cb}}))

    t_cli = time.perf_counter()
    cli_line, cli_launches = run_cli()
    print(json.dumps({"cli": {**cli_line, "phase_s": time.perf_counter() - t_cli}}))
    t_boot = time.perf_counter()
    boot = check_bootstrap()
    print(json.dumps({"bootstrap": {**boot, "n": 45, "n_boot": 1000, "confidence": 0.99,
                                    "tolerance": BOOT_TOL,
                                    "phase_s": time.perf_counter() - t_boot}}))
    t_obs = time.perf_counter()
    obs_line, obs_launches = run_obs_service(cli_line["kernels_wall_s"])
    print(json.dumps({"obs_service": {**obs_line, "phase_s": time.perf_counter() - t_obs}}))

    times = {
        "card": card,
        "build_s": build_s,
        "occupancy": occupancy,
        "k1_serve_shape": {"max_abs_err": k1_err, "tolerance_share": k1_share,
                           **{k: k1[k] for k in _TIME_KEYS + ("flops", "bytes")}},
        "k2_serve_shape": {"max_abs_err": k2_err, "tolerance_share": k2_share,
                           "rounding": k2_rounding_split,
                           **{k: k2[k] for k in _TIME_KEYS + (
                               "bf16_operands_ms", "bf16_operands_device_ms", "flops",
                               "bytes")}},
        "serve": serve,
        "ssm_serve": ssm_serve,
        "wall_s": time.perf_counter() - t_start,
    }
    print(json.dumps({"times": times}))
    print(json.dumps({"kernels": [
        _kernel_line("K1 flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:32", k1_launches,
                     duet_launches["K1"], cli_launches["K1"], obs_launches["K1"], k1_err, k1),
        _kernel_line("K2 ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:31", k2_launches,
                     duet_launches["K2"], cli_launches["K2"], obs_launches["K2"], k2_err, k2),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
