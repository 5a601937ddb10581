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
   (bf16 takes a tensor-core variant: K1 "wg", wgmma and TMA, at hd 64 and
   128, where K1's mma.sync "tc" kernel is held on the same inputs too, and
   "tc" at the other multiples of 16; K2 "wg", split over the sequence,
   wgmma and TMA, at P and N of 64 and 128, where it is held again at 1, 2
   and 3 segments and ``k2_segments``'s count, called twice for the same
   bits, and K2's mma.sync "tc" kernel is held on the same inputs too, and
   "tc" at the other bf16 shapes; f32 takes the CUDA-core "fma"); at K2's
   serve shape, split the error into operand rounding ("tc" writing y in
   f32, held to half the tolerance; "wg" against the f32 plain version
   beside "fma") and output rounding, beside the "fma" kernel and the tc kernel
   on bf16 operands only, on the same inputs;
4. serve: ``repro_torch.launch.serve`` on internlm2-1.8b at full width
   (24 layers, seeded random bf16 weights), batch 4, prompt 1024, 32 new
   tokens, flash prefill; count the kernel launches of that run by variant
   (24 K1 "wg"), check the logits, prefill->decode consistency, and
   flash against dot prefill;
5. serve, SSM: the same entry point on mamba2-1.3b at full width (48
   layers), batch 4, prompt 1024, 32 new tokens; every prefill layer's SSD
   goes through K2; count the launches by variant (48 K2 "wg", none in
   decode), check the tokens, the logits and prefill->decode consistency
   (K2 prefill against the plain decode recurrence);
6. times: kernel (and, on the same inputs, its other variants: K1 "tc" and
   "fma", K2 "tc" and "fma"), plain version, library call and serve times,
   bound and the share of it each kernel reaches, as JSON.
   ``ms`` is the median of
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
11. families: ``repro_torch.launch.serve`` on the MoE, enc-dec, vlm and
   hybrid families, batch 4, 32 new tokens, each model freed before the
   next: (a) phi3.5-moe-42b-a6.6b at full width, 8 of its 32 layers,
   prompt 1024; (b) whisper-medium whole (24 encoder + 24 decoder layers),
   1,500 frames, prompt 32; (c) llava-next-34b at full width, 8 of its 60
   layers, 2,880 prefix embeddings + 1,024 tokens; (d) jamba-1.5-large-398b
   at ``reduced()`` (full width needs more than one card).  Each run
   counts its launches (K1 once per self-attention layer of the prefill,
   the encoder's non-causal, K2 once per Mamba layer, none in decode),
   records every K1 call (no cross-attention takes it) and the decode
   positions, and holds bf16 prefill->decode rel < 0.08 with
   capacity_factor 16 at 1 layer (the whole reduced jamba) and, for (a)
   and (c), flash against dot at 1 layer.  (a) also holds the index-buffer
   MoE against the dense oracle at one layer's serve shape (f32 1e-4, bf16
   3e-2 of the largest |y|) and times the MoE FFN's share of a layer.
   Each run also profiles one warm prefill and one decode step
   (torch.profiler): device ms, its share of the host-clock time, and the
   five longest kernels.
   (e) K1 at the whisper encoder and llava prefill shapes ("wg" and "tc")
   and K2 ("wg") at Jamba's mixer shape and the mamba2 train microbatch
   against their plain versions, then timed beside SDPA (K1), "tc" on the
   same inputs and their bounds.  The ``families`` JSON line gives each run's
   times, peak memory, launches and checks.
12. train: ``repro_torch.launch.train.main`` in this process, as a user
   starts it, seeded random bf16 weights, each model freed before the
   next.  (e) reduced internlm2, lr 1e-2, warmup 5, no weight decay: 14
   steps with a checkpoint at step 12, then step 12 copied into a second
   directory where the same command must resume from step 12; the two
   step_14 checkpoints must be equal byte for byte.  (c) internlm2 and
   mamba2 cut to 1 layer at full width, batch 2 x 256, f32: one step's
   loss and every leaf's gradient on the card against the same port on
   the CPU (each leaf within 1e-4 of its norm + 1e-6), remat "dots"
   against "none" on the card (1e-6), every gradient nonzero; for mamba2
   also the gradient through ``SSDScanFn`` (K2 "fma") against autograd
   through the plain scan on the card (1e-4), and the bf16 step (K2 "wg")
   against the f32 one (each leaf within 5e-2 of its norm).  (a)
   internlm2-1.8b at full width (24 layers, remat "dots"), seq 4,096,
   global batch 8 in 4 microbatches of 2, 4 steps at lr 3e-4: no K1 or K2
   launch (the chunked attention at 4,096 positions, as in JAX); (d) the
   same model 2 steps with int8 optimizer state: the peak memory drops by
   the int8 saving of m and v within 20%, and the step-2 loss is within
   1e-2 of (a)'s; (b) mamba2-1.3b at full width (48 layers) as (a): K2
   "wg" once per layer and microbatch (192 a step: remat "dots" keeps its
   outputs, and ``SSDScanFn``'s backward reruns the plain scan).  For
   (a) and (b) each step's loss, lr, grad_norm and seconds, the warm step
   time (steps 2-4), tokens/s, peak GB and the share of the dense bf16
   peak that 6 N tokens per step is, then one microbatch's forward and
   backward, gradient sum and AdamW update timed and profiled.  The
   ``train`` JSON line gives each part's numbers.
13. bench: the paper's tables, the benchmark scripts and the examples, as
   users start them, outputs under ``build/chip_smoke_bench/``.  (a)
   ``repro_torch.benchmarks.run.main([])`` in this process: every table of
   ``ALL_TABLES`` on the host, then the kernel duets on the card; each
   simulated table's rows, their host fields dropped, must equal the JAX
   package's at seed 0 by SHA-256, the duets must come back with 12 pairs
   and a finite median and CI each, K2 "fma" (the SSD duet) must have been
   launched and K1 not, and the only ``-1`` row may be the roofline row's
   "no dry-run results" line; the tables' harness seconds are printed as
   host numbers.  (b) the benchmark scripts' CI lines on the host: ``chaos_bench
   --quick --check``, ``obs_bench --quick --check``, ``replan_bench --quick
   --check-baseline BENCH_replan.json`` and ``service_bench
   --check-baseline BENCH_service.json`` must exit 0; ``perf_bench --quick``
   and ``engine_bench --quick`` must exit 0 (their own equality and
   bit-exact assertions), and their speedups, host numbers, are printed,
   not gated.  (c) the examples: ``continuous_benchmarking`` on the host,
   its output equal to the JAX example's by SHA-256; ``quickstart`` on the
   card, one verdict line; ``serve_batch`` on the card for internlm2 and
   mamba2 (reduced, batch 4, prompt 32): K1 or K2 "tc" once per prefill
   layer and none in decode, finite logits, and the kernel held against
   its plain version on the inputs the model gave its first call;
   ``train_lm`` on the card, its 200 steps' losses finite and the last
   below the first.  The ``bench`` JSON line gives each part's numbers.
14. cells and the dry run.  (a) ``launch.cells.build_cell`` on a real 1x1
   mesh on the card, full width, seeded random bf16 weights:
   internlm2-1.8b at prefill_32k (batch cut from 32 to 1, flash attention:
   K1 "wg" 24 times at S = 32,768), mamba2-1.3b at prefill_32k (batch 1: K2
   "wg" 48 times), internlm2-1.8b at decode_32k (int8 cache, batch cut from
   128 to 32: ~53 GB of cache) and mamba2-1.3b at decode_32k (batch 128).
   Each cell runs once with the launch counts set to 0 just before and read
   just after, its logits finite; then its warm time (median of 3, CUDA
   events), the per-device account of the same call (``analysis.account``),
   whose FLOPs must equal those of the meta dry run of the same 1x1 cell,
   and the roofline terms with the card's own constants
   (``analysis.roofline``): ``roofline_fraction`` (model FLOPs over the
   bound's time at peak, JAX's definition) and ``achieved_fraction`` (over
   the warm time).  Before the cells, K1 and K2 at the prefill cells'
   shapes against their plain versions (bf16 tolerances, row by row as in
   11 (e); K1 "wg" and "tc"; the plain K1 a block of 2,048 query rows at a
   time), timed beside their bounds, "tc" on the same inputs and, for K1,
   SDPA; K2 "wg" also at each segment count of ``K2_SEGMENT_SWEEP``.  (b) ``python -m
   repro_torch.launch.dryrun`` on the host (meta DTensors over a fake
   process group, no card), one single-threaded process per cell, all six
   started after the last timed phase (so that no host time above is
   measured beside them) and each given ``DRYRUN_TIMEOUT_S``: internlm2-1.8b and
   phi3.5-moe-42b-a6.6b at train_4k and decode_32k on 16x16, internlm2-1.8b
   train_4k on 2x16x16, mamba2-1.3b prefill_32k, phi3.5-moe-42b-a6.6b,
   jamba-1.5-large-398b and internlm2-1.8b prefill_32k, and mamba2 and
   jamba train_4k in one microbatch, on 16x16; each record ok with its
   per-device FLOPs equal to
   JAX's record (``tests/data/jax_dryrun_records.jsonl``) plus the
   difference ``analysis.parity`` derives (the SSD's K2 and plain-scan
   backward), an all-reduce among the train cells' collectives, the
   decode cells' collectives within twice JAX's, and the plan fields of
   JAX's ``make_plan``.  The ``cells`` and ``dryrun``
   JSON lines give each cell's numbers; records and logs are in
   ``build/chip_smoke_dryrun/``.

The last line of standard output is the device line
``{"ok": true, "device": {...}}``.  The script imports nothing of jax or
of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
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
_K1_DEFAULTS = dict(causal=True, window=0, kv_valid=None, softmax_scale=None)
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
# phase 11: the MoE, enc-dec, vlm and hybrid families through the same entry
# point, each at batch 4 and 32 new tokens; (arch, serve flags, layers kept)
FAMILY_RUNS = {
    "moe": ("phi3.5-moe-42b-a6.6b", ["--prompt-len", "1024"], 8),
    "encdec": ("whisper-medium", ["--prompt-len", "32"], None),
    "vlm": ("llava-next-34b", ["--prompt-len", "1024"], 8),
    "hybrid": ("jamba-1.5-large-398b", ["--prompt-len", "1024", "--reduced"], None),
}
MOE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}    # tests/test_moe.py:39-41; K1's bf16 twin


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
    for key, query, dims in [("K1", flash_attention.occupancy,
                              {"wg": (64, 128), "tc": (128, 256), "fma": (128, 256)}),
                             ("K2", ssd_scan.occupancy,
                              {"wg": (64, 128), "tc": (64, 128), "fma": (64, 128)})]:
        for variant, variant_dims in dims.items():
            for dim in variant_dims:
                smem, blocks = query(variant, dim)
                out[f"{key} {variant} {'hd' if key == 'K1' else 'P'}={dim}"] = {
                    "smem_bytes": smem, "blocks_per_sm": blocks}
                if key == "K2" and variant == "wg" and blocks != ssd_scan.WG_BLOCKS_PER_SM[dim]:
                    fail(f"K2 wg at P={dim}: {blocks} blocks a SM on the card, but "
                         f"k2_segments counts {ssd_scan.WG_BLOCKS_PER_SM[dim]}")
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
    """K1 against its plain version on the card; where the call takes "wg",
    the "tc" kernel on the same inputs too.  Returns the serve-shape error
    and its share of the tolerance."""
    import torch
    from repro_torch.kernels.flash_attention import (_launch, flash_attention_hmajor,
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
    # the ragged, windowed and kv_valid cases again at the head dims "wg" takes
    cases.append(("bf16 ragged windowed GQA hd=128", (2, 300, 300, 8, 2, 128), bf16,
                  dict(causal=True, window=37), 3e-2))
    cases.append(("bf16 ragged kv_valid hd=64", (2, 77, 200, 4, 2, 64), bf16,
                  dict(causal=False, kv_valid=150), 3e-2))
    cases.append(("bf16 ragged kv_valid causal hd=128", (1, 257, 129, 2, 2, 128), bf16,
                  dict(causal=True, kv_valid=100), 3e-2))
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
        ref = flash_attention_hmajor_plain(q, k, v, **kw).float()
        runs = [(variant, out)]
        if variant == "wg":     # the kernel "wg" took over, held on the same inputs
            runs.append(("tc", _launch(q, k, v, "tc", **{**_K1_DEFAULTS, **kw})))
            torch.cuda.synchronize()
        for run_variant, got in runs:
            if got.dtype != dtype or got.shape != q.shape:
                fail(f"K1 {name} [{run_variant}]: got {got.dtype} {tuple(got.shape)}")
            a = got.float()
            max_err, share, bad = _agreement(a, ref, tol)
            log(f"K1 {name} [{run_variant}]: max_abs_err {max_err:.3e} (atol=rtol={tol}, "
                f"share {share:.3f}) {'ok' if bad == 0 else f'{bad} entries out of tolerance'}")
            if bad or not torch.isfinite(a).all():
                fail(f"K1 ({run_variant}) disagrees with its plain version on {name}")
            if name == "bf16 serve shape" and run_variant == variant:
                serve = max_err, share
    return serve


def _reset_launches():
    """Set every kernel's launch counts to 0; returns the wrappers by kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_hmajor
    from repro_torch.kernels.ssd_scan import ssd_scan_hmajor
    wrappers = {"K1": flash_attention_hmajor, "K2": ssd_scan_hmajor}
    for w in wrappers.values():
        w.launches = 0
        w.launches_by_variant.update(dict.fromkeys(w.launches_by_variant, 0))
    return wrappers


def _serve_counted(args, cfg=None):
    """Drive ``serve.run(args, cfg=cfg)`` with every kernel's launch counts
    set to 0 just before and read just after; returns (result, {kernel:
    launches}, {kernel: {variant: launches}})."""
    from repro_torch.launch import serve
    wrappers = _reset_launches()
    res = serve.run(args, cfg=cfg)
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
    ``ssd_ref`` on the f32 cases and the bf16 cases "wg" takes).  Where a
    call takes "wg" (bf16 at P, N of 64 and 128), the same inputs go through
    "wg" again at 1, 2 and 3 segments and at ``k2_segments``'s count, the
    public call twice (the same bits both times: no atomics), and through
    "tc", each held the same way.  Returns the serve-shape error with its
    share of the tolerance, and that error split by ``k2_rounding``."""
    import torch
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import (WG_BLOCKS_PER_SM, WG_CHUNK, _launch, k2_segments,
                                              k2_variant, ssd_scan_hmajor,
                                              ssd_scan_hmajor_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
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
    # "wg" at P and N of 64 and 128: ragged S, h0, G > 1, dt in bf16
    for name, shape, with_h0, dt_dtype in [
            ("(2,333,4,2,64,64) h0", (2, 333, 4, 2, 64, 64), True, f32),
            ("(1,300,4,2,128,128)", (1, 300, 4, 2, 128, 128), False, f32),
            ("(2,517,4,1,128,64) h0 dt bf16", (2, 517, 4, 1, 128, 64), True, bf16),
            ("(1,1000,8,1,64,128) h0", (1, 1000, 8, 1, 64, 128), True, f32)]:
        cases.append((f"bf16 {name}", shape, 64, bf16, dt_dtype, with_h0, 5e-2))
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
        if dtype == f32 or (variant == "wg" and "serve" not in name):
            refs["ssd_ref"] = ssd_ref(x, dt, A, Bi, Ci, h0=h0)
        runs = [(variant, y, st)]
        if variant == "wg":
            rule = k2_segments(B, H, S, sm_count, WG_BLOCKS_PER_SM[P])
            for n in sorted({1, 2, 3, rule} & set(range(1, -(-S // WG_CHUNK) + 1))):
                runs.append((f"wg segments={n}{' (the rule)' if n == rule else ''}",
                             *_launch(x, dt, A, Bi, Ci, h0, "wg", bf16, segments=n)))
            again = ssd_scan_hmajor(x, dt, A, Bi, Ci, chunk=chunk, h0=h0)
            torch.cuda.synchronize()
            if not (torch.equal(again[0], y) and torch.equal(again[1], st)):
                fail(f"K2 {name}: two wg calls on the same inputs differ")
            runs.append(("tc", *_launch(x, dt, A, Bi, Ci, h0, "tc", bf16)))
            torch.cuda.synchronize()
        for run_name, y_run, st_run in runs:
            if (y_run.dtype != dtype or y_run.shape != x.shape or st_run.dtype != f32
                    or st_run.shape != (B, H, P, N)):
                fail(f"K2 {name} [{run_name}]: got y {y_run.dtype} {tuple(y_run.shape)}, "
                     f"state {st_run.dtype} {tuple(st_run.shape)}")
            if not (torch.isfinite(y_run.float()).all() and torch.isfinite(st_run).all()):
                fail(f"K2 {name} [{run_name}]: output is not finite")
            for ref_name, (yr, sr) in refs.items():
                ey = _agreement(y_run.float(), yr.float(), tol)
                es = _agreement(st_run, sr, tol)
                bad = ey[2] + es[2]
                log(f"K2 {name} [{run_name}] vs {ref_name}: max_abs_err y {ey[0]:.3e} state "
                    f"{es[0]:.3e} (atol=rtol={tol}, share y {ey[1]:.3f} state {es[1]:.3f}) "
                    f"{'ok' if bad == 0 else f'{bad} entries out of tolerance'}")
                if bad:
                    fail(f"K2 ({run_name}) disagrees with {ref_name} on {name}")
                if "serve" in name and run_name == variant:
                    serve = max(ey[0], es[0]), max(ey[1], es[1])
        if "serve" in name:
            rounding = k2_rounding(x, dt, A, Bi, Ci, y, tol)
    return serve, rounding


def k2_rounding(x, dt, A, Bi, Ci, y_wg, tol):
    """Where K2's bf16 serve-shape error comes from.  y is stored in bf16 on
    both sides, so the error against the plain version holds the operand
    rounding of the tensor-core products and, at an entry where the two
    unrounded values straddle a rounding boundary, one bf16 step of output
    rounding.  "wg" (``y_wg``, every operand a hi + lo bf16 pair) is held
    against the plain version in f32 and rounded to bf16, beside the "fma"
    kernel, whose error against the f32 plain version is output rounding
    alone.  The "tc" kernel writing y in f32 gives its operand
    rounding alone; the "fma" kernel (fp32 products) on the same inputs
    gives the floor that output rounding sets.  "tc" runs att @ x and C @
    state^T on tf32 operands; the same kernel with every product on bf16
    operands (``tf32=False``) is measured beside it."""
    import torch
    from repro_torch.kernels import ssd_scan as ks
    ref32, _ = ks.ssd_scan_hmajor_plain(x.float(), dt, A, Bi.float(), Ci.float(), chunk=256)
    ref = ref32.to(torch.bfloat16).float()
    y_tc, _ = ks._launch(x, dt, A, Bi, Ci, None, "tc", torch.bfloat16)
    y_pre, _ = ks._launch(x, dt, A, Bi, Ci, None, "tc", torch.float32)
    y_fma, _ = ks._launch(x, dt, A, Bi, Ci, None, "fma", torch.bfloat16)
    y_b16, _ = ks._launch(x, dt, A, Bi, Ci, None, "tc", torch.bfloat16, tf32=False)
    y_b16_pre, _ = ks._launch(x, dt, A, Bi, Ci, None, "tc", torch.float32, tf32=False)
    torch.cuda.synchronize()
    out = {"max_abs_y": float(ref32.abs().max()),
           "tc_f32_y_rounds_to_tc_y": bool(torch.equal(y_pre.to(torch.bfloat16), y_tc))}
    for label, got, against in [("wg_vs_plain", y_wg, ref), ("wg_vs_plain_f32", y_wg, ref32),
                                ("tc_vs_plain", y_tc, ref), ("fma_vs_plain", y_fma, ref),
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
    if (launches != cfg.num_layers or by_variant["K1"]["wg"] != cfg.num_layers
            or counts["K2"] != 0):
        fail(f"launches {counts} {by_variant} in the internlm2 serve run, want K1 "
             f"{cfg.num_layers} on wgmma (\"wg\", one per layer of the prefill) and K2 0")
    return res, launches, by_variant


def _k2_variant_of(cfg):
    """The K2 variant a bf16 model's Mamba-2 layers take (``k2_variant``):
    "wg" at full width, "tc" at ``reduced()``'s P = N = 16."""
    import torch
    from repro_torch.kernels.ssd_scan import k2_variant
    return k2_variant(torch.bfloat16, cfg.ssm.head_dim, cfg.ssm.d_state)


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
    k2v = _k2_variant_of(cfg)
    if (launches != cfg.num_layers or by_variant["K2"][k2v] != cfg.num_layers
            or counts["K1"] != 0):
        fail(f"launches {counts} {by_variant} in the mamba2 serve run, want K2 "
             f"{cfg.num_layers} on \"{k2v}\" (one per layer of the prefill, none in "
             "decode) and K1 0")
    return res, launches, by_variant


def _consistency(lm, prompts, nxt, kv_dtype, inputs=None):
    """rel. max difference of the last logits: full forward against prefill
    followed by one decode step (tests/test_models_smoke.py:58-93).
    ``inputs`` holds the enc-dec family's frames or the vlm's image prefix,
    which shifts the decode position by its length."""
    import torch
    from repro_torch.launch.serve import grow_cache
    cfg = lm.cfg
    kw = inputs or {}
    S = prompts.shape[1] + (kw["embeds_prefix"].shape[1] if "embeds_prefix" in kw else 0)
    full = lm.forward(torch.cat([prompts, nxt], 1), mode="train", **kw)["logits"]
    pf = lm.forward(prompts, mode="prefill", kv_dtype=kv_dtype, **kw)
    cache = grow_cache(cfg, pf["cache"], 2 * S)
    logits_d, _ = lm.decode(cache, nxt, S)
    a = full[:, -1, :cfg.vocab_size].float()
    b = logits_d[:, 0, :cfg.vocab_size].float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("train or decode logits are not finite")
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-6))


def _flash_vs_dot(lm, tokens, mode, inputs=None):
    """Distributional distance of flash logits from dot logits (the measures
    of tests/test_integration_extras.py:33-37), in train or prefill mode."""
    cfg = lm.cfg
    kw = inputs or {}
    flash = lm.forward(tokens, mode=mode, **kw)["logits"][..., :cfg.vocab_size].float()
    lm.cfg = dataclasses.replace(cfg, attention_impl="dot")
    try:
        dot = lm.forward(tokens, mode=mode, **kw)["logits"][..., :cfg.vocab_size].float()
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


def time_prefill(lm, prompts, n=3, inputs=None):
    """Warm prefill time (host clock around synchronised calls), median ms."""
    import torch
    times = []
    with torch.inference_mode():
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.forward(prompts, mode="prefill", **(inputs or {}))
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


def _k1_work(q, k, causal):
    """(flops, bytes) of one K1 call: ``flash_attention.work`` (q.k and p.v
    over the (q, k) pairs the mask keeps, 2 flops per MAC; q, k, v read and
    the output written once), what ``analysis.account`` counts for it."""
    from repro_torch.kernels.flash_attention import work
    return work(tuple(q.shape), (k.shape[1], k.shape[2]), causal=causal,
                itemsize=q.element_size())


def _bound(flops, nbytes, dtype="bfloat16"):
    """(least ms for the work, "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_k1_at(B, Sq, Skv, H, K, hd, causal=True, seed=99, fma_calls=25, plain=None):
    """K1 on bf16 inputs at one shape: the variant the serve path takes
    (``variant``, "wg" at hd 64/128) through the public wrapper, its times;
    on the same inputs the "tc" kernel where "wg" took over, the CUDA-core
    "fma" kernel (median of ``fma_calls`` single calls), the plain version
    (``plain``, default the module's; its time is the median of 3 calls when
    given), SDPA and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (_launch, flash_attention_hmajor,
                                                     flash_attention_hmajor_plain, k1_variant)
    q, k, v = _qkv(B, Sq, Skv, H, K, hd, torch.bfloat16, seed=seed)
    kw = dict(_K1_DEFAULTS, causal=causal)
    variant = k1_variant(q.dtype, hd)
    kernel = lambda: flash_attention_hmajor(q, k, v, causal=causal)
    library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    out = dict(variant=variant, ms=_time_ms(kernel), device_ms=_device_ms(kernel))
    if variant == "wg":
        tc = lambda: _launch(q, k, v, "tc", **kw)
        out.update(tc_ms=_time_ms(tc), tc_device_ms=_device_ms(tc))
    out["fma_ms"] = _time_ms(lambda: _launch(q, k, v, "fma", **kw), n=fma_calls,
                             warmup=min(3, fma_calls))
    out["plain_ms"] = (_time_ms(lambda: flash_attention_hmajor_plain(q, k, v, causal=causal))
                       if plain is None else _time_ms(lambda: plain(q, k, v, causal=causal), n=3,
                                                      warmup=1))
    out.update(library_ms=_time_ms(library), library_device_ms=_device_ms(library))
    flops, nbytes = _k1_work(q, k, causal)
    bound_ms, bound_by = _bound(flops, nbytes)
    return dict(out, bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
                device_tflops=flops / out["device_ms"] / 1e9)


def time_k1():
    s = SERVE_SHAPE
    return time_k1_at(s["B"], s["Sq"], s["Skv"], s["H"], s["K"], s["hd"])


def _k2_work(x, dt, Bi):
    """(flops, bytes) of one K2 call: ``ssd_scan.work`` (bytes read and
    written once, the fp32 state included; operations of the chunk-256
    block decomposition), what ``analysis.account`` counts for it."""
    from repro_torch.kernels.ssd_scan import work
    return work(tuple(x.shape), Bi.shape[1], Bi.shape[3], x_itemsize=x.element_size(),
                dt_itemsize=dt.element_size())


def time_k2_at(B, S, H, G, P, N, seed=98, variants=True, sweep=()):
    """K2 on bf16 inputs at one shape: the variant the serve path takes
    (``variant``, "wg" at P, N of 64 / 128, with ``k2_segments``'s count
    ``segments``) through the public wrapper, its times; on the same inputs
    the "tc" kernel where "wg" took over (``tc_ms``, ``tc_device_ms``), with
    ``variants`` the CUDA-core variant and the bf16-operand tc kernel, and
    "wg"'s ``device_ms`` at each segment count of ``sweep``; the plain
    version, the bound and the share of the bound each kernel reaches."""
    from repro_torch.kernels.ssd_scan import (WG_BLOCKS_PER_SM, WG_CHUNK, _launch, k2_segments,
                                              k2_variant, ssd_scan_hmajor,
                                              ssd_scan_hmajor_plain)
    import torch
    x, dt, A, Bi, Ci = _ssd_inputs(B, S, H, G, P, N, torch.bfloat16, seed=seed, serve=True)
    variant = k2_variant(x.dtype, P, N)
    kernel = lambda: ssd_scan_hmajor(x, dt, A, Bi, Ci)
    out = dict(variant=variant, ms=_time_ms(kernel), device_ms=_device_ms(kernel))
    if variant == "wg":
        out["segments"] = k2_segments(B, H, S, torch.cuda.get_device_properties(0)
                                      .multi_processor_count, WG_BLOCKS_PER_SM[P])
        tc = lambda: _launch(x, dt, A, Bi, Ci, None, "tc", torch.bfloat16)
        out.update(tc_ms=_time_ms(tc), tc_device_ms=_device_ms(tc))
        out["segment_sweep"] = {
            n: _device_ms(lambda: _launch(x, dt, A, Bi, Ci, None, "wg", torch.bfloat16,
                                          segments=n))
            for n in sweep if n <= -(-S // WG_CHUNK)}
    if variants:
        out["fma_ms"] = _time_ms(lambda: _launch(x, dt, A, Bi, Ci, None, "fma", torch.bfloat16))
        bf16_ops = lambda: _launch(x, dt, A, Bi, Ci, None, "tc", torch.bfloat16, tf32=False)
        out["bf16_operands_ms"] = _time_ms(bf16_ops)
        out["bf16_operands_device_ms"] = _device_ms(bf16_ops)
    out["plain_ms"] = _time_ms(lambda: ssd_scan_hmajor_plain(x, dt, A, Bi, Ci, chunk=256))
    flops, nbytes = _k2_work(x, dt, Bi)
    bound_ms, bound_by = _bound(flops, nbytes)
    out["bound_share"] = bound_ms / out["device_ms"]
    if "tc_device_ms" in out:
        out["tc_bound_share"] = bound_ms / out["tc_device_ms"]
    return dict(out, library_ms=None, library_device_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, flops=flops, bytes=nbytes)


def time_k2():
    s = SSM_SERVE_SHAPE
    return time_k2_at(s["B"], s["S"], s["H"], s["G"], s["P"], s["N"])


def _device_profile(fn, top=0):
    """Device work of one warm call of ``fn()`` from the CUDA events of a
    torch.profiler trace: {"items", "device_ms", "top": the ``top`` kernels
    by device time as [name, ms, count]}; items and ms None where the trace
    holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        return {"items": None, "device_ms": None, "top": []}
    events.sort(key=lambda e: -e.self_device_time_total)
    return {"items": sum(e.count for e in events),
            "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in events[:top]]}


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
            prof = _device_profile(lambda: fn(*inputs))
            out[name].update({f"{side}_device_items": prof["items"],
                              f"{side}_device_ms": prof["device_ms"]})
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
    """``repro_torch.cb.cli.main(argv)`` in this process (``_in_process``):
    (exit code, stdout lines, wall s, {kernel: launches}), the counts set to
    0 just before.  The command line installs its observability context and
    leaves it in place; it is put back after the run, so that the next run
    starts clean."""
    from repro_torch.cb import cli
    code, out, _, wall, launches, _, _ = _in_process(cli.main, argv)
    return code, out.splitlines(), wall, launches


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


def _family_args(name):
    arch, flags, _ = FAMILY_RUNS[name]
    return ["--arch", arch, "--batch", "4", "--gen", str(GEN), "--attention-impl", "flash",
            "--kv-dtype", "bfloat16", "--seed", "0", "--device", "cuda", *flags]


def _cut(cfg, layers):
    """``cfg`` cut to ``layers`` decoder layers (and, for the enc-dec family,
    as many encoder layers)."""
    kw = {"num_layers": layers}
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, num_layers=layers)
    return dataclasses.replace(cfg, **kw)


def _no_drops(cfg):
    """capacity_factor 16, as tests/test_models_smoke.py:63-66 sets it for
    the prefill->decode equivalence."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


def _serve_family(name):
    """Phase 11's serve run of one family, with the kernel launches counted
    and every K1 call and decode position recorded.  Returns (result,
    launches, launches by variant, K1 calls [(causal, q shape, k shape)],
    decode positions)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    arch, _, layers = FAMILY_RUNS[name]
    cfg = None if layers is None else dataclasses.replace(get_config(arch), num_layers=layers)
    calls, positions = [], []
    flash, decode = kops.flash_attention, LM.decode

    def record_flash(q, k, v, **kw):
        calls.append((kw.get("causal", True), tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    def record_decode(lm, cache, token, pos):
        positions.append(pos)
        return decode(lm, cache, token, pos)

    kops.flash_attention, LM.decode = record_flash, record_decode
    try:
        torch.cuda.reset_peak_memory_stats()
        res, counts, by_variant = _serve_counted(_family_args(name), cfg=cfg)
    finally:
        kops.flash_attention, LM.decode = flash, decode
    return res, counts, by_variant, calls, positions


def _family_checks(res, name):
    """The held model-level checks of one family run, on the same width cut
    to 1 layer (the whole reduced model for the hybrid run): bf16
    prefill->decode rel < 0.08 with capacity_factor 16 and, for the MoE
    and vlm runs, flash against dot."""
    import torch
    from repro_torch.models.lm import LM
    lm, prompts, inputs = res.lm, res.prompts, res.inputs
    cfg = lm.cfg
    g = torch.Generator(device="cuda").manual_seed(5)
    nxt = torch.randint(0, cfg.vocab_size, (prompts.shape[0], 1), generator=g, device="cuda")
    layers = cfg.num_layers if name == "hybrid" else 1
    out = {"layers": layers}
    with torch.inference_mode():
        short = LM(_no_drops(_cut(cfg, layers)), device="cuda", seed=0)
        out["bf16_prefill_decode_rel"] = _consistency(short, prompts, nxt, "bfloat16", inputs)
        if name in ("moe", "vlm"):
            # llava's dot path at 3,904 positions materialises [B,K,G,S,S] f32
            # scores (13.7 GB at batch 4): batch 1 there
            b = 1 if name == "vlm" else prompts.shape[0]
            out["flash_vs_dot_batch"] = b
            out["bf16_flash_vs_dot_train"] = _flash_vs_dot(
                short, prompts[:b], "train", {k: v[:b] for k, v in inputs.items()})
        del short
    if not out["bf16_prefill_decode_rel"] < 0.08:
        fail(f"{cfg.name}: bf16_prefill_decode_rel={out['bf16_prefill_decode_rel']:.4f} at "
             f"{layers} layers (limit 0.08)")
    if "bf16_flash_vs_dot_train" in out and not _close(out["bf16_flash_vs_dot_train"]):
        fail(f"{cfg.name}: flash vs dot at 1 layer out of bounds: "
             f"{out['bf16_flash_vs_dot_train']}")
    return out


def check_moe_dispatch(lm):
    """The index-buffer MoE against the dense oracle on the card, at the
    serve shape of one phi3.5-moe layer (T = 4 x 1024, E 16, top-2, C 640)
    with that layer's experts: f32 at atol = rtol = 1e-4, bf16 within 3e-2
    of the largest |y|.  Both share the router, so they pick the same
    experts; only the order of the sums differs."""
    import torch
    from repro_torch.models import moe as moe_mod
    cfg = lm.cfg
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((4, 1024, cfg.d_model), generator=g, device="cuda")
    T = x.shape[0] * x.shape[1]
    out = {"T": T, "E": cfg.moe.num_experts, "C": moe_mod._capacity(T, cfg.moe)}
    params = dict(lm.blocks[0].moe)
    for dtype, tol in MOE_TOL.items():
        dt = getattr(torch, dtype)
        p = {k: v.to(dt) for k, v in params.items()}
        with torch.inference_mode():
            y, aux = moe_mod.moe_ffn_index(x.to(dt), p, cfg.moe)
            y_ref, aux_ref = moe_mod.moe_ffn_dense(x.to(dt), p, cfg.moe)
        err = (y.float() - y_ref.float()).abs()
        ref_max = float(y_ref.float().abs().max())
        if dtype == "float32":
            share = float((err / (tol + tol * y_ref.abs())).max())
        else:
            share = float(err.max()) / (tol * ref_max)
        out[dtype] = {"max_abs_err": float(err.max()), "max_abs_y": ref_max,
                      "tolerance_share": share, "aux_diff": abs(float(aux) - float(aux_ref))}
        del p, y, y_ref
        if not share <= 1.0 or not torch.isfinite(err).all():
            fail(f"MoE index path vs dense oracle, {dtype}: {out[dtype]}")
    log(f"MoE index path vs dense oracle at T={T}, E={out['E']}, C={out['C']}: "
        f"{json.dumps(out)}")
    return out


def moe_layer_share(lm):
    """Device ms of one phi3.5-moe layer at the serve shape and of its MoE
    FFN alone (CUDA events around single calls, median of 25)."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import rms_norm
    cfg = lm.cfg
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((4, 1024, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    blk = lm.blocks[0]
    xf = rms_norm(x, blk.ln2, cfg.norm_eps)
    with torch.inference_mode():
        layer_ms = _time_ms(lambda: lm._layer(0, x))
        moe_ms = _time_ms(lambda: moe_mod.moe_ffn(xf, blk.moe, cfg.moe))
    return {"layer_ms": layer_ms, "moe_ms": moe_ms, "moe_share": moe_ms / layer_ms}


def _serve_device_profile(res, S):
    """Device time of one warm prefill and one decode step of a serve run's
    model (torch.profiler), as a share of their host-clock times: how much
    of each the card is busy, and its five longest kernels."""
    import torch
    from repro_torch.launch.serve import grow_cache
    lm, prompts, kw = res.lm, res.prompts, res.inputs
    with torch.inference_mode():
        prefill = _device_profile(lambda: lm.forward(prompts, mode="prefill", **kw), top=5)
        cache = grow_cache(lm.cfg, lm.forward(prompts, mode="prefill", **kw)["cache"], S + 1)
        tok = torch.as_tensor(res.tokens[:, :1], device=prompts.device)
        decode = _device_profile(lambda: lm.decode(cache, tok, S), top=5)
    return {"prefill": prefill, "decode": decode}


def run_family(name):
    """One phase 11 run: serve, the launch and shape checks, the model-level
    checks, times and peak memory; frees the model before returning."""
    import torch
    from repro_torch.kernels.flash_attention import k1_variant
    res, counts, by_variant, calls, positions = _serve_family(name)
    cfg = res.lm.cfg
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    _check_tokens(res)
    n_attn = cfg.num_layers // cfg.hybrid.attn_period if cfg.hybrid else cfg.num_layers
    want_k1 = n_attn + (cfg.encoder.num_layers if cfg.encoder else 0)
    want_k2 = cfg.num_layers - n_attn if cfg.hybrid else 0
    k1v = k1_variant(torch.bfloat16, cfg.head_dim)   # "wg" at hd 64/128, "tc" at Jamba's 16
    k2v = _k2_variant_of(cfg) if cfg.ssm is not None else "wg"   # Jamba reduced(): "tc"
    if (counts["K1"] != want_k1 or by_variant["K1"][k1v] != want_k1
            or counts["K2"] != want_k2 or by_variant["K2"][k2v] != want_k2):
        fail(f"{cfg.name}: launches {counts} {by_variant}, want K1 {want_k1} ({k1v}) and K2 "
             f"{want_k2} ({k2v}), all on the tensor cores, in one prefill and none in decode")
    S = res.prompts.shape[1] + cfg.num_image_tokens
    self_calls = [c for c in calls if c[1][1] == c[2][1]]
    enc_calls = [c for c in calls if not c[0]]
    if (len(calls) != want_k1 or len(self_calls) != len(calls)
            or len(enc_calls) != (cfg.encoder.num_layers if cfg.encoder else 0)
            or any(c[1][1] != S for c in calls if c[0])):
        fail(f"{cfg.name}: K1 calls {sorted(set(calls))}: want self-attention only (cross-"
             "attention on the dot path), non-causal exactly in the encoder, causal at "
             f"{S} positions")
    if positions != list(range(S, S + GEN - 1)):
        fail(f"{cfg.name}: decode positions {positions[:3]}..., want {S}..{S + GEN - 2}")
    line = {"arch": cfg.name, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder.num_layers if cfg.encoder else None,
            "batch": 4, "prompt_len": res.prompts.shape[1], "prefix_len": cfg.num_image_tokens,
            "gen": GEN, "prefill_ms": res.prefill_s * 1e3,
            "prefill_warm_ms": time_prefill(res.lm, res.prompts, inputs=res.inputs),
            "decode_ms_per_token": res.decode_s / (GEN - 1) * 1e3,
            "tok_per_s": 4 * (GEN - 1) / res.decode_s, "peak_gb": peak_gb,
            "launches": counts, "launches_by_variant": by_variant,
            "k1_calls": dict(Counter(f"causal={c} q={list(q)} k={list(k)}"
                                     for c, q, k in calls)),
            "first_decode_pos": positions[0]}
    line["device"] = _serve_device_profile(res, S)
    for step, host_ms in (("prefill", line["prefill_warm_ms"]),
                          ("decode", line["decode_ms_per_token"])):
        ms = line["device"][step]["device_ms"]
        line["device"][step]["busy_share"] = None if ms is None else ms / host_ms
    if name == "hybrid":
        line["full_width"] = ("jamba-1.5-large-398b at full width needs more than one card: "
                              "one 8-layer period is ~88 GB of bf16 weights")
    if name == "moe":
        line["dispatch_vs_dense"] = check_moe_dispatch(res.lm)
        line["moe_layer"] = moe_layer_share(res.lm)
    line["checks"] = _family_checks(res, name)
    log(f"{name}: {json.dumps(line)}")
    del res
    torch.cuda.empty_cache()
    return line


# the kernels at the shapes of phase 11's families and of phase 12's
# mamba2 train microbatch: (name, kernel, shape, dtypes, inputs); inputs
# "drawn" come from ``_qkv``/``_ssd_inputs``, "train" are K2's inputs in a
# mamba2-1.3b microbatch (``_mamba2_train_ssd_inputs``)
NEW_SHAPES = [
    ("K1 whisper encoder", "K1", dict(B=4, Sq=1500, Skv=1500, H=16, K=16, hd=64, causal=False),
     ("float32", "bfloat16"), "drawn"),
    ("K1 llava prefill", "K1", dict(B=4, Sq=3904, Skv=3904, H=56, K=8, hd=128, causal=True),
     ("bfloat16",), "drawn"),
    ("K2 jamba mixer", "K2", dict(B=4, S=1024, H=128, G=1, P=128, N=128), ("float32", "bfloat16"),
     "drawn"),
    ("K2 mamba2 train microbatch", "K2", dict(B=2, S=4096, H=64, G=1, P=64, N=128),
     ("float32", "bfloat16"), "train"),
]
KERNEL_TOL = {("K1", "float32"): 2e-5, ("K1", "bfloat16"): 3e-2,
              ("K2", "float32"): 1e-4, ("K2", "bfloat16"): 5e-2}


def _row_share(a, b, tol):
    """The largest ||a_r - b_r|| / (tol ||b_r||) over the rows r of the last
    dim: the output's own scale in each row.  At random N(0, 1) inputs an
    attention row over ~1500 keys averages to |o| ~ 0.03, as small as the
    bf16 atol, so only a bound relative to the row sees a kernel that is a
    few percent off or drops a key tile there."""
    err = (a - b).norm(dim=-1)
    return float((err / (tol * b.norm(dim=-1)).clamp_min(1e-30)).max())


def _hold(label, pairs, tol, rows):
    """Each (kernel output, plain output) pair within atol = rtol = ``tol``,
    and with ``rows`` each output row within ``tol`` of its own norm
    (``_row_share``); fails otherwise.  Returns the largest error and shares."""
    import torch
    err = share = row = 0.0
    for a, b in pairs:
        e, sh, bad = _agreement(a.float(), b.float(), tol)
        if bad or not torch.isfinite(a.float()).all():
            fail(f"{label}: {bad} entries out of atol=rtol={tol}")
        err, share = max(err, e), max(share, sh)
        if rows:
            row = max(row, _row_share(a.float(), b.float(), tol))
    held = {"max_abs_err": err, "tolerance": tol, "tolerance_share": share}
    if rows:
        held["row_tolerance_share"] = row
        if not row <= 1.0:
            fail(f"{label}: a row's error is {row:.3f} x {tol} of its norm")
    return held


def _mamba2_train_ssd_inputs():
    """K2's inputs as a mamba2-1.3b train microbatch gives them: the forward
    of the full-depth model (seeded random bf16 weights, as phase 12 (b))
    on 2 x 4,096 synthetic tokens, keeping the SSD call whose chunks decay
    most (the largest sum of dt |A| over a chunk's 256 positions; the
    gradient's exp overflow came from these sums).  Returns (x, dt, A, B,
    C) head-major, and that largest sum."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.lm import LM
    from repro_torch.train import data as data_mod
    from repro_torch.train.train_step import make_loss_fn
    cfg = get_config(TRAIN_RUNS["mamba2"])
    lm = LM(cfg, device="cuda", seed=0)
    ds = data_mod.SyntheticDataset(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=4096, global_batch=2, accum_steps=1), cfg)
    mb = {k: v[0] for k, v in data_mod.batch_to_device(ds.batch(0), "cuda").items()}
    best = {"decay": -1.0}
    real = ssm_mod.ssd_scan_hmajor

    def grab(x, dt, A, B, C, *, chunk, h0=None):
        decay = float((dt * -A[:, None]).unflatten(-1, (-1, chunk)).sum(-1).max())
        if decay > best["decay"]:
            best.update(decay=decay, inputs=tuple(t.clone() for t in (x, dt, A, B, C)))
        return real(x, dt, A, B, C, chunk=chunk, h0=h0)

    ssm_mod.ssd_scan_hmajor = grab
    try:
        with torch.no_grad():
            make_loss_fn(lm)(mb)
    finally:
        ssm_mod.ssd_scan_hmajor = real
    del lm
    torch.cuda.empty_cache()
    return best["inputs"], best["decay"]


def check_new_shapes():
    """Phase 11 (e): K1 and K2 at the shapes the new families and the mamba2
    train microbatch give them, each against its plain version on the card
    (phases 2-3's tolerances, with the share used; in bf16 each output row
    also within the tolerance of its own norm, ``_row_share``), K1's "tc"
    kernel too where "wg" serves, then timed as ``time_k1``/``time_k2`` time
    them.  The train shape holds K2 on the inputs the model gives it (its
    f32 case on the same inputs cast up)."""
    import torch
    from repro_torch.kernels.flash_attention import (_launch, flash_attention_hmajor,
                                                     flash_attention_hmajor_plain, k1_variant)
    from repro_torch.kernels.ssd_scan import ssd_scan_hmajor, ssd_scan_hmajor_plain
    out = []
    for i, (label, kernel, shape, dtypes, inputs) in enumerate(NEW_SHAPES):
        entry = {"name": label, "shape": shape, "inputs": inputs}
        if inputs == "train":
            train_inputs, entry["max_chunk_decay"] = _mamba2_train_ssd_inputs()
            got = tuple(train_inputs[0].shape), tuple(train_inputs[3].shape)
            want = ((shape["B"], shape["H"], shape["S"], shape["P"]),
                    (shape["B"], shape["G"], shape["S"], shape["N"]))
            if got != want:
                fail(f"{label}: the model gives K2 x and B of {got}, want {want}")
        for dtype in dtypes:
            dt, tol = getattr(torch, dtype), KERNEL_TOL[(kernel, dtype)]
            if kernel == "K1":
                kw = dict(causal=shape["causal"])
                q, k, v = _qkv(shape["B"], shape["Sq"], shape["Skv"], shape["H"], shape["K"],
                               shape["hd"], dt, seed=300 + i)
                ref = flash_attention_hmajor_plain(q, k, v, **kw)
                pairs = [(flash_attention_hmajor(q, k, v, **kw), ref)]
                if k1_variant(dt, shape["hd"]) == "wg":
                    tc_pair = (_launch(q, k, v, "tc", **{**_K1_DEFAULTS, **kw}), ref)
                del q, k, v
            else:
                if inputs == "train":
                    x, dt_, A, Bi, Ci = (t.to(dt) if t.dtype == torch.bfloat16 else t
                                         for t in train_inputs)
                else:
                    x, dt_, A, Bi, Ci = _ssd_inputs(shape["B"], shape["S"], shape["H"],
                                                    shape["G"], shape["P"], shape["N"], dt,
                                                    seed=300 + i, serve=True)
                pairs = list(zip(ssd_scan_hmajor(x, dt_, A, Bi, Ci),
                                 ssd_scan_hmajor_plain(x, dt_, A, Bi, Ci, chunk=256)))
                del x, dt_, A, Bi, Ci
            torch.cuda.synchronize()
            entry[dtype] = _hold(f"{label} {dtype}", pairs, tol, rows=dtype == "bfloat16")
            if kernel == "K1" and k1_variant(dt, shape["hd"]) == "wg":
                entry[dtype]["tc"] = _hold(f"{label} {dtype} [tc]", [tc_pair], tol, rows=True)
                del tc_pair
            del pairs
            torch.cuda.empty_cache()
        train_inputs = None
        if kernel == "K1":
            t = time_k1_at(shape["B"], shape["Sq"], shape["Skv"], shape["H"], shape["K"],
                           shape["hd"], causal=shape["causal"], seed=310 + i, fma_calls=5)
        else:
            t = time_k2_at(shape["B"], shape["S"], shape["H"], shape["G"], shape["P"], shape["N"],
                           seed=310 + i, variants=False)
        entry.update({k: t[k] for k in _TIME_KEYS + ("flops", "bytes") if k in t})
        entry["max_abs_err"] = entry["bfloat16"]["max_abs_err"]
        torch.cuda.empty_cache()
        log(f"{label}: {json.dumps(entry)}")
        out.append(entry)
    return out


# ------------------------------------------------------------ phase 12: train
# (a) and (b): seq 4,096 as train_4k; global batch 8 (train_4k's 256 cut to 8)
# in 4 microbatches of 2, the per-device microbatch the cells' rule aims at
TRAIN_STEPS = 4
TRAIN_ARGS = ["--seq-len", "4096", "--global-batch", "8", "--accum", "4", "--lr", "3e-4",
              "--log-every", "1", "--seed", "0", "--device", "cuda"]
TRAIN_RUNS = {"internlm2": "internlm2-1.8b", "mamba2": "mamba2-1.3b"}
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)       # per leaf: |g - g_ref| <= rtol |g_ref| + atol
REMAT_TOL = 1e-6                            # dots against none: relative, loss and each leaf
# the bf16 step (K2 wg) against the f32 step, per leaf, relative to the f32
# gradient's norm: K2's own bf16 tolerance, which its bf16 output uses up
# to 0.2 of at the serve shapes (phase 3, phase 11 (e)); a gradient
# through one bf16 layer carries errors of the same order as its output
BF16_GRAD_TOL = 5e-2
DENSE_BF16_PEAK = PEAK_FLOPS["bfloat16"]


def _train_counted(argv, ocfg=None):
    """``repro_torch.launch.train.main(argv, ocfg=ocfg)`` with every
    kernel's launch counts set to 0 just before and read just after, and the
    peak device memory of the run.  Returns (result, launches, launches by
    variant, peak GB)."""
    import torch
    from repro_torch.launch import train
    wrappers = _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = train.main(argv, ocfg=ocfg)
    torch.cuda.synchronize()
    return (res, {k: w.launches for k, w in wrappers.items()},
            {k: dict(w.launches_by_variant) for k, w in wrappers.items()},
            torch.cuda.max_memory_allocated() / 1e9)


def _train_split(res, ocfg):
    """Where a train step's time goes, after the run: one microbatch's
    forward and backward, adding its gradients into the stacked fp32 sum,
    and one AdamW update of the state (CUDA events around single calls,
    two of each after a warm one); and a torch.profiler pass over one
    microbatch with its gradient sum: device ms and the 8 longest
    kernels."""
    import torch
    from repro_torch.models.convert import jax_layout
    from repro_torch.train import data as data_mod
    from repro_torch.train.optimizer import apply_updates_
    from repro_torch.train.train_step import add_grads_, loss_and_grads, make_loss_fn
    from repro_torch.train.tree import unflatten
    lm, state = res.lm, res.state
    cfg = lm.cfg
    ds = data_mod.SyntheticDataset(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=4096, global_batch=2, accum_steps=1), cfg)
    mb = data_mod.batch_to_device(ds.batch(0), lm.device)
    loss_fn = make_loss_fn(lm)
    layout = jax_layout(lm)
    gsum = {key: torch.zeros(shape, device=lm.device) for key, (shape, _) in layout.items()}
    fwd_bwd, grad_sum = [], []
    for i in range(3):
        t = _time_ms(lambda: loss_fn({k: v[0] for k, v in mb.items()}).backward(), n=1,
                     warmup=0)
        g = _time_ms(lambda: add_grads_(gsum, layout, "bfloat16"), n=1, warmup=0)
        if i:
            fwd_bwd.append(t)
            grad_sum.append(g)
    grads = unflatten({k: v.div_(3) for k, v in gsum.items()})
    out = {"fwd_bwd_ms": fwd_bwd, "grad_sum_ms": grad_sum,
           "adamw_ms": _time_ms(lambda: apply_updates_(state["params"], grads, state["opt"],
                                                        ocfg), n=2, warmup=1)}
    del grads, gsum
    out["microbatch_profile"] = _device_profile(lambda: loss_and_grads(lm, mb), top=8)
    ms = out["microbatch_profile"]["device_ms"]
    out["microbatch_profile"]["busy_share"] = (
        None if ms is None else ms / (statistics.mean(fwd_bwd) + statistics.mean(grad_sum)))
    return out


def run_train(name, ocfg=None, steps=TRAIN_STEPS, after=None):
    """Phase 12 (a), (b): ``launch.train`` on one model at full width, seeded
    random bf16 weights, with the optimizer config its flags give unless
    ``ocfg`` replaces it; the steps' losses, rates and times, the peak
    memory and the kernel launches (K1 none: training takes the chunked
    attention at 4,096 positions; K2 "wg" once per Mamba-2 layer and
    microbatch, and once more under remat "full", whose recompute runs it
    again).  ``after(res)`` runs on the trained
    result and its dict joins the line.  Frees the model before
    returning."""
    import torch
    from repro_torch.configs import get_config
    arch = TRAIN_RUNS[name]
    cfg = get_config(arch)
    res, counts, by_variant, peak_gb = _train_counted(
        ["--arch", arch, "--steps", str(steps), *TRAIN_ARGS], ocfg=ocfg)
    accum = 4
    per_layer = 2 if cfg.remat == "full" else 1     # "dots" keeps K2's outputs
    want_k2 = cfg.num_layers * accum * per_layer * steps if cfg.family == "ssm" else 0
    k2v = _k2_variant_of(cfg) if cfg.family == "ssm" else "wg"
    if counts["K1"] != 0 or counts["K2"] != want_k2 or by_variant["K2"][k2v] != want_k2:
        fail(f"{arch} train: launches {counts} {by_variant}, want K1 0 and K2 {want_k2} "
             f"({k2v}), one per Mamba-2 layer and microbatch")
    losses = [s["loss"] for s in res.steps]
    if len(res.steps) != steps or not all(math.isfinite(s["loss"]) and math.isfinite(
            s["grad_norm"]) for s in res.steps):
        fail(f"{arch} train: steps {res.steps}")
    warm = [s["seconds"] for s in res.steps[1:]]
    step_s = statistics.mean(warm) if warm else res.steps[0]["seconds"]
    n_params = cfg.param_count()
    line = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "remat": cfg.remat, "params": n_params, "seq": 4096, "global_batch": 8,
            "accum": accum, "microbatch": 2, "steps": res.steps,
            "warm_step_ms": [s * 1e3 for s in warm], "warm_step_ms_mean": step_s * 1e3,
            "tokens_per_s": res.tokens_per_step / step_s, "peak_gb": peak_gb,
            "dense_bf16_peak_share": 6 * n_params * res.tokens_per_step / step_s
            / DENSE_BF16_PEAK, "launches": counts, "launches_by_variant": by_variant,
            "k2_per_step": counts["K2"] // steps, "loss_first_last": [losses[0], losses[-1]],
            "optimizer": dataclasses.asdict(res.ocfg)}
    if steps == TRAIN_STEPS:
        line["split"] = _train_split(res, res.ocfg)
    if after is not None:
        line.update(after(res))
    log(f"train {name}: {json.dumps(line)}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return line


def _grads_of(lm, batch, grad_dtype="float32"):
    """(loss, {key path: gradient}) of one step's batch."""
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.tree import items
    loss, grads = loss_and_grads(lm, batch, grad_dtype)
    return float(loss), dict(items(grads))


def _grad_shares(got, want, rtol, atol=0.0):
    """Per leaf, ||got - want|| / (rtol ||want|| + atol), on the CPU in f64."""
    out = {}
    for key, w in want.items():
        w = w.double().cpu()
        d = float((got[key].double().cpu() - w).norm())
        out[key] = d / (rtol * float(w.norm()) + atol)
    return out


def check_train_grads():
    """Phase 12 (c): one step's loss and gradients of internlm2 and mamba2 cut
    to 1 layer at full width, batch 2 x 256, f32 with TF32 off: the card
    against the same port on the CPU from the same weights and batch
    (each leaf within ``GRAD_TOL``); remat "dots" against "none" on the card
    (``REMAT_TOL``); every leaf's gradient nonzero.  For mamba2 also the
    gradient through ``SSDScanFn`` (K2 "fma" forward) against autograd
    through the plain scan on the card, and the bf16 step (K2 "wg") against
    the f32 one (``BF16_GRAD_TOL``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.lm import LM
    from repro_torch.train import data as data_mod
    out = {}
    for name, arch in TRAIN_RUNS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=1, dtype="float32")
        ds = data_mod.SyntheticDataset(data_mod.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=256, global_batch=2, accum_steps=1), cfg)
        host_batch = ds.batch(0)
        batch = data_mod.batch_to_device(host_batch, "cuda")
        lm = LM(cfg, device="cuda", seed=0)
        bf16_state = {k: v.clone() for k, v in lm.state_dict().items()}
        lm.float().requires_grad_(True)
        r = {"remat": cfg.remat}
        wrappers = _reset_launches()
        loss, grads = _grads_of(lm, batch)
        r["k2_launches"] = dict(wrappers["K2"].launches_by_variant)
        if cfg.family == "ssm" and r["k2_launches"] != {"wg": 0, "tc": 0, "fma": 1}:
            fail(f"{arch} 1 layer f32 step: K2 launches {r['k2_launches']}, want fma 1 "
                 "(the forward: remat \"dots\" keeps K2's outputs)")
        zero = [k for k, g in grads.items() if not bool(g.abs().max() > 0)]
        if zero:
            fail(f"{arch} 1 layer: zero gradient in {zero}")
        lm.cfg = dataclasses.replace(cfg, remat="none")
        loss_none, grads_none = _grads_of(lm, batch)
        lm.cfg = cfg
        shares = _grad_shares(grads, grads_none, REMAT_TOL)
        r["remat_dots_vs_none"] = {"loss_rel": abs(loss - loss_none) / abs(loss_none),
                                   "max_share": max(shares.values()),
                                   "worst": max(shares, key=shares.get)}
        if not (r["remat_dots_vs_none"]["loss_rel"] <= REMAT_TOL
                and r["remat_dots_vs_none"]["max_share"] <= 1):
            fail(f"{arch} 1 layer: remat dots vs none {r['remat_dots_vs_none']}")
        if cfg.family == "ssm":
            real = ssm_mod.ssd_scan_hmajor
            ssm_mod.ssd_scan_hmajor = ssd_scan.ssd_scan_hmajor_plain
            try:
                wrappers = _reset_launches()
                loss_plain, grads_plain = _grads_of(lm, batch)
            finally:
                ssm_mod.ssd_scan_hmajor = real
            if wrappers["K2"].launches:
                fail(f"{arch}: the plain-scan reference launched K2")
            shares = _grad_shares(grads, grads_plain, **GRAD_TOL)
            r["ssdscanfn_vs_plain_on_card"] = {
                "loss_rel": abs(loss - loss_plain) / abs(loss_plain),
                "max_share": max(shares.values()), "worst": max(shares, key=shares.get)}
            if not max(shares.values()) <= 1:
                fail(f"{arch}: SSDScanFn gradient vs the plain scan's {shares}")
            lm_bf = LM(dataclasses.replace(cfg, dtype="bfloat16"), device="cuda", seed=0)
            lm_bf.load_state_dict(bf16_state)
            lm_bf.requires_grad_(True)
            wrappers = _reset_launches()
            loss_bf, grads_bf = _grads_of(lm_bf, batch, "bfloat16")
            want = {"wg": 0, "tc": 0, "fma": 0, _k2_variant_of(cfg): 1}
            if wrappers["K2"].launches_by_variant != want:
                fail(f"{arch} bf16 step: K2 launches {wrappers['K2'].launches_by_variant}")
            rel = {k: v * BF16_GRAD_TOL for k, v in
                   _grad_shares(grads_bf, grads, BF16_GRAD_TOL).items()}
            r["bf16_vs_f32"] = {"loss_rel": abs(loss_bf - loss) / abs(loss), "rel": rel,
                                "max_rel": max(rel.values()), "bound": BF16_GRAD_TOL}
            if not max(rel.values()) <= BF16_GRAD_TOL:
                fail(f"{arch}: bf16 gradient vs f32 {rel}")
            del lm_bf, grads_bf
        # the same port on the CPU, from the same weights and batch
        lm_cpu = LM(cfg, device="cpu", seed=0).float()
        lm_cpu.load_state_dict(lm.state_dict())
        lm_cpu.requires_grad_(True)
        loss_cpu, grads_cpu = _grads_of(lm_cpu, data_mod.batch_to_device(host_batch, "cpu"))
        shares = _grad_shares(grads, grads_cpu, **GRAD_TOL)
        r["card_vs_cpu"] = {"loss": loss, "loss_cpu": loss_cpu,
                            "loss_rel": abs(loss - loss_cpu) / abs(loss_cpu),
                            "max_share": max(shares.values()),
                            "worst": max(shares, key=shares.get)}
        if not (r["card_vs_cpu"]["loss_rel"] <= GRAD_TOL["rtol"] and max(shares.values()) <= 1):
            fail(f"{arch} 1 layer: card vs CPU {r['card_vs_cpu']} {shares}")
        r["leaves"] = len(grads)
        out[name] = r
        log(f"train grads {name}: {json.dumps(r)}")
        del lm, lm_cpu, grads, grads_cpu
        torch.cuda.empty_cache()
    return out


def check_train_restart():
    """Phase 12 (e): reduced internlm2 on the card, lr 1e-2, warmup 5, no
    weight decay (tests/test_system.py:25-39): 14 steps with a checkpoint at
    step 12 into directory A; step 12 copied into directory B and the same
    command run there must resume from step 12; both step_14 checkpoints
    must be equal byte for byte."""
    import contextlib
    import io
    import shutil
    from repro_torch.train.optimizer import OptimizerConfig
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    a, b = root / "a", root / "b"
    ocfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=5, weight_decay=0.0,
                           total_steps=14)
    argv = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "14", "--ckpt-every", "12",
            "--log-every", "100", "--device", "cuda"]
    res_a, counts_a, _, _ = _train_counted([*argv, "--ckpt-dir", str(a)], ocfg=ocfg)
    shutil.copytree(a / "step_12", b / "step_12")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res_b, counts_b, _, _ = _train_counted([*argv, "--ckpt-dir", str(b)], ocfg=ocfg)
    print(text.getvalue(), end="", flush=True)
    if "resumed from step 12" not in text.getvalue() or res_b.start_step != 12:
        fail(f"train restart: the second run did not resume from step 12: {text.getvalue()!r}")
    files = sorted(p.name for p in (a / "step_14").iterdir())
    if files != sorted(p.name for p in (b / "step_14").iterdir()):
        fail("train restart: the two step_14 checkpoints hold different files")
    differ = [f for f in files if (a / "step_14" / f).read_bytes()
              != (b / "step_14" / f).read_bytes()]
    if differ:
        fail(f"train restart: step_14 files differ: {differ}")
    out = {"files": len(files), "equal": True,
           "losses_12_13": [[s["loss"] for s in res_a.steps[12:]],
                            [s["loss"] for s in res_b.steps]],
           "loss_first_last": [res_a.steps[0]["loss"], res_a.steps[-1]["loss"]],
           "launches": [counts_a, counts_b]}
    log(f"train restart: {json.dumps(out)}")
    return out


# (d): the int8 path's master and parameters against the f32 path's from
# the same decoded state, per leaf relative to the leaf's largest entry
# (the same float32 operations on the same values: equal but for
# rounding); its new codes decode within Q8_CODE_SHARE of half a block
# scale s of the f32 path's new m and sqrt(v): round to nearest leaves
# s / 2, and the float32 roundings of x / s and of q * s (|q| <= 127) add
# up to 127 s 2^-24 each, so the share is at most 1 + 4 * 127 * 2^-24,
# plus 3 roundings of the comparison itself
Q8_MASTER_TOL = 1e-6
Q8_CODE_SHARE = 1 + (4 * 127 + 3) * 2.0 ** -24


def _q8_decode_here(q8):
    """Int8 state {"q", "scale"} as f32: each block of 256 flattened codes
    times its scale, written apart from ``quantized_state.q8_decode`` so
    that a fault there shows against it."""
    import torch
    from repro_torch.train.quantized_state import BLOCK
    q, scale = q8["q"], q8["scale"]
    per_entry = scale.repeat_interleave(BLOCK)[:q.numel()].view(q.shape)
    return q.float() * per_entry, per_entry


def check_q8_update(res):
    """Phase 12 (d): one more AdamW update from the int8 run's state, made
    twice on the card from that state and one seeded N(0, 1) gradient: by
    the int8 path, and by the f32 path from m and sqrt(v) decoded with
    ``_q8_decode_here``.  A fault in the int8 path's decode moves its master
    and parameters off the f32 path's (``Q8_MASTER_TOL``); a fault in its
    encode moves its new codes more than half a block scale off the f32
    path's new m and sqrt(v) (``Q8_CODE_SHARE``).  Also the state's bytes
    (``state_bytes``) against int8 codes plus an f32 scale per block."""
    import torch
    from repro_torch.train.optimizer import apply_updates_
    from repro_torch.train.quantized_state import n_blocks, state_bytes
    from repro_torch.train.tree import items, tree_map
    params, opt, ocfg = res.state["params"], res.state["opt"], res.ocfg
    keys = [k for k, _ in items(params)]

    def paired(*trees):
        """{key path: the leaves of ``trees`` at it} (an int8 leaf as its dict)."""
        out = []
        tree_map(lambda p, *t: out.append(t), params, *trees)
        return dict(zip(keys, out))

    nbytes = state_bytes({"m": opt["m"], "v": opt["v"]})
    want_bytes = 2 * sum(p.numel() + 4 * n_blocks(p.shape) for _, p in items(params))
    device = opt["step"].device
    g = torch.Generator(device=device).manual_seed(12)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g, device=device), params)
    ref = {"m": tree_map(lambda p, q: _q8_decode_here(q)[0], params, opt["m"]),
           "v": tree_map(lambda p, q: _q8_decode_here(q)[0].square_(), params, opt["v"]),
           "master": tree_map(torch.clone, opt["master"]), "step": opt["step"].clone()}
    ref_params = tree_map(torch.clone, params)
    metrics_ref = apply_updates_(ref_params, grads, ref, dataclasses.replace(ocfg, state_bits=32))
    metrics_q8 = apply_updates_(params, grads, opt, ocfg)
    del grads
    got_p, want_p = dict(items(params)), dict(items(ref_params))
    master_rel, share = {}, {"m": {}, "sqrt_v": {}}
    for key, (m, want_m, v, want_v, master, want_master) in paired(
            opt["m"], ref["m"], opt["v"], ref["v"], opt["master"], ref["master"]).items():
        master_rel[key] = max(float((master - want_master).abs().max()),
                              float((got_p[key].float() - want_p[key].float()).abs().max())
                              ) / (float(want_master.abs().max()) or 1.0)
        for part, q8, want in (("m", m, want_m), ("sqrt_v", v, want_v.sqrt())):
            dec, per_entry = _q8_decode_here(q8)
            share[part][key] = float(((dec - want).abs() / (0.5 * per_entry)).max())
            del dec, per_entry
    del ref, ref_params, got_p, want_p
    torch.cuda.empty_cache()
    out = {"state_bytes": nbytes, "state_bytes_want": want_bytes,
           "lr": [float(metrics_q8["lr"]), float(metrics_ref["lr"])],
           "grad_norm": [float(metrics_q8["grad_norm"]), float(metrics_ref["grad_norm"])],
           "master_rel_max": max(master_rel.values()),
           "master_worst": max(master_rel, key=master_rel.get),
           "master_tol": Q8_MASTER_TOL, "code_share_bound": Q8_CODE_SHARE,
           **{f"{part}_code_share_max": max(d.values()) for part, d in share.items()},
           **{f"{part}_code_worst": max(d, key=d.get) for part, d in share.items()}}
    log(f"train q8 update: {json.dumps(out)}")
    if nbytes != want_bytes:
        fail(f"train q8: m and v take {nbytes} bytes, int8 codes and block scales {want_bytes}")
    if not out["master_rel_max"] <= Q8_MASTER_TOL:
        fail(f"train q8: the int8 update's master is {out['master_rel_max']:.3e} of the leaf "
             f"off the f32 update's from the decoded state ({out['master_worst']})")
    for part in share:
        if not out[f"{part}_code_share_max"] <= Q8_CODE_SHARE:
            fail(f"train q8: new {part} codes decode {out[f'{part}_code_share_max']:.4f} x half "
                 f"a block scale off the f32 update's ({out[f'{part}_code_worst']})")
    return {"q8_update": out}


def run_train_phase():
    """Phase 12: (e), (c), (a), (d), (b); returns the ``train`` JSON line's
    body and the launches of (a) and (b) by kernel."""
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    line = {"restart": check_train_restart(), "grads_1_layer": check_train_grads()}
    line["internlm2"] = run_train("internlm2")
    # the schedule of (a)'s flags (warmup 1, cosine to 4 steps), int8 m and v
    q8 = run_train("internlm2", steps=2, after=check_q8_update, ocfg=OptimizerConfig(
        learning_rate=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS, state_bits=8))
    n = get_config(TRAIN_RUNS["internlm2"]).param_count()
    saving_gb = 2 * (4 * n - (n + 4 * n / 256)) / 1e9       # m and v: f32 -> int8 + scales
    drop = line["internlm2"]["peak_gb"] - q8["peak_gb"]
    # the first update starts from zero m and v, so step 2's loss equals (a)'s;
    # the updates that decode int8 state are held by ``check_q8_update``
    loss_rel = abs(q8["steps"][1]["loss"] - line["internlm2"]["steps"][1]["loss"]) / abs(
        line["internlm2"]["steps"][1]["loss"])
    line["q8"] = {"peak_gb": q8["peak_gb"], "peak_drop_gb": drop,
                  "predicted_drop_gb": saving_gb, "step2_loss": q8["steps"][1]["loss"],
                  "step2_loss_rel": loss_rel, "steps": q8["steps"],
                  "update": q8["q8_update"]}
    log(f"train q8: {json.dumps(line['q8'])}")
    if not (0.8 * saving_gb <= drop <= 1.2 * saving_gb and loss_rel <= 1e-2):
        fail(f"train q8: peak drop {drop:.2f} GB (int8 m and v save {saving_gb:.2f} GB), "
             f"step-2 loss {loss_rel:.2e} relative from the f32 state's (limit 1e-2)")
    line["mamba2"] = run_train("mamba2")
    line["phase_s"] = time.perf_counter() - t0
    launches = {k: {TRAIN_RUNS[name]: line[name]["launches"][k] for name in TRAIN_RUNS}
                for k in ("K1", "K2")}
    return line, launches


# ---------------------------------------------- phase 13: tables, benchmark scripts, examples
# each simulated table's rows of `python -m benchmarks.run --skip-real` (the JAX
# package, seed 0, on a CPU), its host fields dropped (``_table_digest``), by
# SHA-256; the kernel duets and the roofline row are held by their structure
TABLE_SHA256 = {
    "aa": "6f06e3039ef6689951f6a8bd629215b96b12a087df7586cefb6d6668f5d70126",
    "baseline_vs_original": "8bb659a52eaa278d126e260334feb5daac5fe1904cad86572e0849862e3a7b8b",
    "replication": "f9c1a6e82a493eadd987828cb32c9c5db8c4764074b35eb5fe9c38f9ab5978c6",
    "lower_memory": "bcd9e576a9d7b8017657cd849d5648a37050a539abd45241fcfb16a69178031d",
    "single_repeat": "3253bc1bb19dce8421702a1fa33afe367e01f88fd915c550d441cf0361b3ed30",
    "possible_changes": "18df8dd125741aa58e91f023cb82f746b3d5d67857ea1e933668279734e659e2",
    "ci_repeats": "9ba7b543bb50896e385a287be42d858a9479058ce6194b535d71633a6c90123e",
    "time_cost_headline": "b2c4571da6e00a727be92480bf52fb16e7c924c04aeff205a3d418e8db353032",
    "parallelism_curve": "65c392b96dcf41e763145e9f114fdb10eeb5bddd6144d47b28e2dc88f5f3ced4",
    "memory_autotune": "ea975b41216175a4f4e720d9523595c9ba4e79b6761877ba0d35427f1f0e108d",
    "adaptive_vs_fixed": "3c51d65dc4a12cf12d8ec628ac46fe35ead96fc894b0d0c22f7f8d169a78b881",
    "pipeline_vs_full": "c10740db49d98bf61020717a5e725e4c59df8456b6e555f5597797a73d7c7d2a",
    "service_pareto": "74c48b6022481bdbc020b5a08b11fb1a71fcf441a224ae6df90441ef605cec6d",
    "multi_tenant_throughput": "1071f00dea92fb0721274ee532d9ed9dabb657c5ec2fe4dc5d5ce5ccfd9a4b13",
    "chaos_robustness": "04cc62174d967b4a49c6dcff77d40797bc036e50bb183cc7e375d6ec15abc976",
    "engine_scaling": "ceb873a74c0045925831746119f33af56dfd3b30f8c5f3afb1ea9b3befe41839",
}
# the host-clock fields of a table's rows: engine_scaling's live rows time the
# host's engines; every other field is virtual time
TABLE_HOST_FIELDS = {"engine_scaling": ("vec_us_per_inv", "scalar_us_per_inv", "speedup")}
# the standard output of `python examples/continuous_benchmarking.py` (the JAX
# package, on a CPU), by SHA-256
CB_EXAMPLE_SHA256 = "6e98bd4ad27137909e6a453266ef5a33e64a58b011469b9725de94752e961e56"
DUET_NAMES = ("attention_dot_vs_chunked", "rmsnorm_fused_vs_unfused",
              "ssd_recurrence_vs_chunked")
SERVE_BATCH_ARCHS = {"internlm2": "internlm2-1.8b", "mamba2": "mamba2-1.3b"}
TRAIN_LM_STEPS = 200          # train_lm's default


def _table_digest(name, rows):
    """SHA-256 of one table's rows without its host fields (the ``live_n_*``
    rows' of ``TABLE_HOST_FIELDS``), as sorted-key JSON."""
    drop = TABLE_HOST_FIELDS.get(name, ())
    rows = {k: ({f: x for f, x in v.items() if f not in drop}
                if k.startswith("live_n_") else v) for k, v in rows.items()}
    return _sha256(json.dumps(rows, sort_keys=True))


def _in_process(fn, argv):
    """``fn(argv)`` in this process with every kernel's launch counts set to
    0 just before and read just after, its standard output and error
    captured.  Returns (exit code, stdout, stderr, wall s, launches,
    launches by variant, fn's return value).  An entry point that installs a
    process-wide observability context or default engine has both put back
    afterwards."""
    import contextlib
    import io
    from repro_torch.faas import engine_vec
    from repro_torch.obs import get_obs, set_obs
    saved = get_obs(), engine_vec._DEFAULT_ENGINE
    wrappers = _reset_launches()
    out, err = io.StringIO(), io.StringIO()
    code, ret = 0, None
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            ret = fn(argv)
            code = ret if isinstance(ret, int) else 0
    except SystemExit as e:
        code = e.code
    finally:
        set_obs(saved[0])
        engine_vec.set_default_engine(saved[1])
    return (code, out.getvalue(), err.getvalue(), time.perf_counter() - t0,
            {k: w.launches for k, w in wrappers.items()},
            {k: dict(w.launches_by_variant) for k, w in wrappers.items()}, ret)


def run_bench_tables():
    """Phase 13 (a): ``repro_torch.benchmarks.run.main([])`` as a user starts
    it: every paper table on the host, then the kernel duets on the card.
    Returns the ``tables`` part of the bench line and its launches."""
    from repro_torch.benchmarks import run
    code, out, err, wall, launches, by_variant, _ = _in_process(run.main, [])
    if code != 0:
        fail(f"benchmarks.run: exit code {code}: {err[-2000:]}")
    rows, errors = {}, {}
    for line in out.splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and parts[2].startswith("{"):
            (errors if parts[1] == "-1" else rows)[parts[0]] = (float(parts[1]),
                                                               json.loads(parts[2]))
    if set(errors) != {"roofline"} or errors["roofline"][1] != {"error": run.NO_DRYRUN}:
        fail(f"benchmarks.run: error rows {errors}; want only the roofline row's "
             f"{run.NO_DRYRUN!r}")
    digests = {name: _table_digest(name, r) for name, (_, r) in rows.items()
               if name in TABLE_SHA256}
    if sorted(rows) != sorted(list(TABLE_SHA256) + ["kernel_duets_real"]):
        fail(f"benchmarks.run: tables {sorted(rows)}, want {sorted(TABLE_SHA256)} and "
             "kernel_duets_real")
    differ = sorted(name for name, d in digests.items() if d != TABLE_SHA256[name])
    if differ:
        fail(f"benchmarks.run: the rows of {differ} differ from the JAX package's: "
             f"{ {n: rows[n][1] for n in differ} }")
    duets = rows["kernel_duets_real"][1]
    for name in DUET_NAMES:
        d = duets.get(name, {})
        vals = [d.get("median_diff_pct", math.nan)] + list(d.get("ci", [math.nan] * 2))
        if d.get("n") != CB_CALLS or not all(math.isfinite(x) for x in vals):
            fail(f"benchmarks.run kernel duets: {name} {d}, want {CB_CALLS} pairs and a finite "
                 "median and CI")
    if (launches["K2"] < 1 or launches["K2"] != by_variant["K2"]["fma"]
            or launches["K1"]):
        fail(f"benchmarks.run: launches {launches} {by_variant}; want K2 'fma' (the SSD duet, "
             "f32) at least once and K1 none")
    harness_s = {name: us / 1e6 for name, (us, _) in rows.items()}
    log(f"benchmarks.run: exit 0 in {wall:.1f} s of host time; {len(digests)} tables equal "
        f"the JAX package's by SHA-256; kernel duets {json.dumps(duets)}; launches {launches} "
        f"{by_variant}; harness s by table (host) {json.dumps(harness_s)}")
    return {"wall_s": wall, "harness_s": harness_s, "tables_equal_jax": len(digests),
            "kernel_duets": duets, "launches": launches, "launches_by_variant": by_variant,
            "roofline": errors["roofline"][1]["error"]}, launches


def run_bench_ci_lines(out):
    """Phase 13 (b): the benchmark scripts' CI lines on the host, ``--out`` under
    ``out``: the virtual-time gates of the chaos, obs, replan and service
    scripts must pass; perf_bench's and engine_bench's own equality and
    bit-exact assertions must hold (their speedups are host numbers and are
    printed, not gated).  Returns the ``ci_lines`` part of the bench line."""
    import importlib
    cases = [("chaos_bench", ["--quick", "--check"]),
             ("obs_bench", ["--quick", "--check"]),
             ("replan_bench", ["--quick", "--check-baseline", str(ROOT / "BENCH_replan.json")]),
             ("service_bench", ["--check-baseline", str(ROOT / "BENCH_service.json")]),
             ("perf_bench", ["--quick"]),
             ("engine_bench", ["--quick"])]
    line = {}
    for name, argv in cases:
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        path = out / f"BENCH_{name.split('_')[0]}.json"
        code, stdout, err, wall, launches, _, _ = _in_process(
            mod.main, argv + ["--out", str(path)])
        if code != 0 or any(launches.values()) or not path.is_file():
            fail(f"{name} {' '.join(argv)}: exit code {code}, launches {launches}, wrote "
                 f"{path.is_file()}: {err[-2000:]}")
        doc = json.loads(path.read_text())
        entry = {"wall_s": wall, "exit": code}
        if name == "perf_bench":
            entry["speedup"] = {k: r["speedup"] for k, r in doc["profiles"]["quick"].items()}
        elif name == "engine_bench":
            entry["speedup"] = {str(r["n_invocations"]): r["speedup"] for r in doc["sizes"]}
        log(f"{name} {' '.join(argv)}: exit 0 in {wall:.2f} s of host time"
            + (f", speedups (host) {entry['speedup']}" if "speedup" in entry else ""))
        line[name] = entry
    return line


def _serve_batch(arch_key):
    """``repro_torch.examples.serve_batch`` on the card for one arch, its
    launches counted, its serve result kept and the inputs of its first K1
    and K2 calls recorded, head-major.  Returns (result, launches, by
    variant, the first calls' inputs by kernel, every call's shapes by
    kernel, stdout, wall s)."""
    from repro_torch.examples import serve_batch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.models import ssm as ssm_mod
    kept, first, shapes = {}, {}, {"K1": Counter(), "K2": Counter()}
    real = serve.run, kops.flash_attention, ssm_mod.ssd_scan_hmajor

    def keep(argv, *, cfg=None):
        kept["res"] = real[0](argv, cfg=cfg)
        return kept["res"]

    def grab_k1(q, k, v, *, causal=True, window=None, softmax_scale=None):
        hmajor = tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))
        first.setdefault("K1", (hmajor, dict(causal=causal, window=0 if window is None
                                             else int(window), softmax_scale=softmax_scale)))
        shapes["K1"][f"q={list(hmajor[0].shape)} k={list(hmajor[1].shape)} {q.dtype}"] += 1
        return real[1](q, k, v, causal=causal, window=window, softmax_scale=softmax_scale)

    def grab_k2(x, dt, A, B, C, **kw):
        first.setdefault("K2", (tuple(t.clone() for t in (x, dt, A, B, C)), dict(kw)))
        shapes["K2"][f"x={list(x.shape)} B={list(B.shape)} {x.dtype}"] += 1
        return real[2](x, dt, A, B, C, **kw)

    def drive(argv):
        serve.run, kops.flash_attention, ssm_mod.ssd_scan_hmajor = keep, grab_k1, grab_k2
        try:
            return serve_batch.main(argv)
        finally:
            serve.run, kops.flash_attention, ssm_mod.ssd_scan_hmajor = real

    code, out, err, wall, launches, by_variant, toks = _in_process(
        drive, ["--arch", SERVE_BATCH_ARCHS[arch_key], "--device", "cuda"])
    if code != 0 or "res" not in kept:
        fail(f"serve_batch {arch_key}: exit code {code}: {err[-2000:]}")
    return kept["res"], launches, by_variant, first, shapes, out, wall


def check_serve_batch(arch_key):
    """Phase 13 (c): serve_batch on the card (the reduced model, batch 4,
    prompt 32, 16 new tokens, as the JAX example serves it): K1 "tc" once per
    prefill attention layer (internlm2) or K2 "tc" once per Mamba-2 layer
    (mamba2), none in decode; finite logits; and the kernel held against its
    plain version on the inputs the model gave its first call."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_hmajor,
                                                     flash_attention_hmajor_plain, k1_variant)
    from repro_torch.kernels.ssd_scan import ssd_scan_hmajor, ssd_scan_hmajor_plain
    res, launches, by_variant, first, shapes, out, wall = _serve_batch(arch_key)
    cfg = res.lm.cfg
    kernel = "K1" if cfg.family != "ssm" else "K2"
    want = {"K1": 0, "K2": 0, kernel: cfg.num_layers}
    variant = (k1_variant(torch.bfloat16, cfg.head_dim) if kernel == "K1"
               else _k2_variant_of(cfg))                 # "tc" at reduced()'s widths
    if launches != want or by_variant[kernel][variant] != cfg.num_layers:
        fail(f"serve_batch {arch_key}: launches {launches} {by_variant}, want {want} on the "
             "tensor cores, all in the prefill")
    if res.tokens.shape != (4, 16) or not torch.isfinite(
            res.prefill_logits[..., :cfg.vocab_size].float()).all():
        fail(f"serve_batch {arch_key}: tokens {res.tokens.shape}, or prefill logits not finite")
    args, kw = first[kernel]
    if kernel == "K1":
        pairs = [(flash_attention_hmajor(*args, **kw), flash_attention_hmajor_plain(*args, **kw))]
    else:
        pairs = list(zip(ssd_scan_hmajor(*args, **kw), ssd_scan_hmajor_plain(*args, **kw)))
    torch.cuda.synchronize()
    tol = KERNEL_TOL[(kernel, "bfloat16")]
    err = share = 0.0
    for a, b in pairs:
        e, sh, bad = _agreement(a.float(), b.float(), tol)
        if bad or not torch.isfinite(a.float()).all():
            fail(f"serve_batch {arch_key}: {kernel} on the model's inputs, {bad} entries out "
                 f"of atol=rtol={tol}")
        err, share = max(err, e), max(share, sh)
    line = {"arch": cfg.name, "layers": cfg.num_layers, "wall_s": wall, "launches": launches,
            "launches_by_variant": by_variant,
            "calls": {k: dict(v) for k, v in shapes.items() if v},
            "kernel_vs_plain": {"kernel": kernel, "max_abs_err": err, "tolerance": tol,
                                "tolerance_share": share},
            "output": out.splitlines()}
    log(f"serve_batch {arch_key}: {json.dumps(line)}")
    del res
    return line


def run_examples(out):
    """Phase 13 (c): the examples.  Returns the ``examples`` part of the bench
    line and serve_batch's launches by arch."""
    import re
    import shutil
    from repro_torch.examples import continuous_benchmarking, quickstart, train_lm
    line = {}
    code, stdout, err, wall, launches, _, _ = _in_process(
        lambda argv: continuous_benchmarking.main(), [])
    if code != 0 or _sha256(stdout) != CB_EXAMPLE_SHA256 or any(launches.values()):
        fail(f"continuous_benchmarking: exit code {code}, stdout sha256 {_sha256(stdout)}, "
             f"launches {launches}; want the JAX example's output and no launch")
    line["continuous_benchmarking"] = {"wall_s": wall, "lines": len(stdout.splitlines())}
    log(f"continuous_benchmarking: {len(stdout.splitlines())} lines in {wall:.1f} s of host "
        "time, equal to the JAX example's by SHA-256")

    code, stdout, err, wall, launches, _, _ = _in_process(quickstart.main, ["--device", "cuda"])
    lines = stdout.splitlines()
    if code != 0 or len(lines) != 2 or not re.fullmatch(
            r"attention_dot_vs_chunked: median diff [+-]\d+\.\d% \(99% CI \[[+-]\d+\.\d%, "
            r"[+-]\d+\.\d%\]\) over 15 duet pairs -> (PERFORMANCE CHANGE|no change)", lines[0]):
        fail(f"quickstart: exit code {code}, output {lines}; want one verdict line")
    line["quickstart"] = {"wall_s": wall, "output": lines, "launches": launches}
    log(f"quickstart on the card: {lines[0]} ({lines[1]}; {wall:.1f} s of host time)")

    line["serve_batch"] = {k: check_serve_batch(k) for k in SERVE_BATCH_ARCHS}

    ckpt = out / "train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    code, stdout, err, wall, launches, _, res = _in_process(
        train_lm.main, ["--device", "cuda", "--ckpt-dir", str(ckpt)])
    losses = [s["loss"] for s in res.steps] if res is not None else []
    if (code != 0 or len(losses) != TRAIN_LM_STEPS or not all(map(math.isfinite, losses))
            or not losses[-1] < losses[0]):
        fail(f"train_lm: exit code {code}, {len(losses)} losses {losses[:3]}...{losses[-3:]}; "
             f"want {TRAIN_LM_STEPS} finite losses, the last below the first: {err[-2000:]}")
    line["train_lm"] = {"wall_s": wall, "steps": len(losses), "loss_first": losses[0],
                        "loss_last": losses[-1], "losses_every_20": losses[::20],
                        "launches": launches}
    log(f"train_lm on the card: {len(losses)} steps in {wall:.1f} s of host time, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches}")
    return line, {k: v["launches"] for k, v in line["serve_batch"].items()}


def run_bench_phase():
    """Phase 13: (a) the paper's tables and the kernel duets, (b) the
    scripts' CI lines, (c) the examples.  Returns the ``bench`` JSON line's
    body, the launches of (a) and those of serve_batch by arch."""
    import shutil
    out = ROOT / "build" / "chip_smoke_bench"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    line = {}
    line["tables"], run_launches = run_bench_tables()
    line["ci_lines"] = run_bench_ci_lines(out)
    line["examples"], serve_batch_launches = run_examples(out)
    line["phase_s"] = time.perf_counter() - t0
    return line, run_launches, serve_batch_launches


def _serve_times(res, prefill_warm_ms, checks):
    cfg = res.lm.cfg
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": 4, "prompt_len": 1024,
            "gen": GEN, "prefill_ms": res.prefill_s * 1e3,
            "prefill_warm_ms": prefill_warm_ms,
            "decode_ms_per_token": res.decode_s / (GEN - 1) * 1e3,
            "tok_per_s": 4 * (GEN - 1) / res.decode_s, "checks": checks}


_TIME_KEYS = ("variant", "segments", "ms", "device_ms", "tc_ms", "tc_device_ms", "fma_ms",
              "plain_ms", "library_ms", "library_device_ms", "device_tflops",
              "bound_ms", "bound_by", "bound_share", "tc_bound_share", "segment_sweep")


def _kernel_line(name, source, replaces, launches, variants, duet_launches, cli_launches,
                 obs_launches, max_abs_err, t, family_launches, shapes, train_launches,
                 bench_launches, serve_batch_launches, cell_launches):
    """One kernel of the serve paths: ``variants`` are its variants and their
    launches in the main path's serve run, and the times are those of the
    variant that run takes; ``tc_ms`` (K1, where that is "wg") and ``fma_ms``
    are its other variants on the same inputs.
    ``launches`` counts the serve run, ``duet_launches`` the pipeline run of
    phase 7, ``cli_launches`` the command line's kernel-suite run of phase 8,
    ``obs_launches`` the observed kernel-suite run of phase 10, and
    ``<family>_launches`` phase 11's serve run of that family,
    ``train_launches`` phase 12's train runs by model, ``bench_launches``
    phase 13's ``benchmarks.run`` and ``serve_batch_launches`` its
    serve_batch runs by arch, ``cell_launches`` phase 14's cell runs; ``shapes``
    holds the kernel at phase 11's new shapes and phase 14's cell shapes."""
    return {"name": name, "route": "cuda", "source": source, "variants": variants,
            "replaces": replaces, "launches": launches, "duet_launches": duet_launches,
            "cli_launches": cli_launches, "obs_launches": obs_launches,
            **{f"{fam}_launches": n for fam, n in family_launches.items()},
            "train_launches": train_launches, "bench_launches": bench_launches,
            "serve_batch_launches": serve_batch_launches, "cell_launches": cell_launches,
            "max_abs_err": max_abs_err, **{k: t[k] for k in _TIME_KEYS if k in t},
            "shapes": shapes}


# ------------------------------------------- phase 14: cells and the dry run
# (a) cells built by ``launch.cells.build_cell`` on a real 1x1 mesh on the
# card, full width, seeded random bf16 weights: (arch, shape, global batch
# or None for the shape's own, config overrides, launches of one run by
# kernel and variant; "k2_variant" stands for ``k2_variant``'s choice at the
# model's widths)
CELL_RUNS = [
    ("internlm2-1.8b", "prefill_32k", 1, {"attention_impl": "flash"},
     {"K1": {"wg": 24}, "K2": {}}),
    ("mamba2-1.3b", "prefill_32k", 1, None, {"K1": {}, "K2": {"k2_variant": 48}}),
    ("internlm2-1.8b", "decode_32k", 32, None, {"K1": {}, "K2": {}}),
    ("mamba2-1.3b", "decode_32k", None, None, {"K1": {}, "K2": {}}),
]
# "wg"'s segment counts timed at the mamba2 prefill_32k shape
K2_SEGMENT_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16, 32, 64)
# K1 and K2 at the prefill_32k cells' shapes (batch 1)
CELL_SHAPES = [
    ("K1 internlm2 prefill_32k", "K1",
     dict(B=1, Sq=32768, Skv=32768, H=16, K=8, hd=128, causal=True), ("bfloat16",), "drawn"),
    ("K2 mamba2 prefill_32k", "K2", dict(B=1, S=32768, H=64, G=1, P=64, N=128),
     ("bfloat16",), "drawn"),
]
# (b) the host-only dry run, `python -m repro_torch.launch.dryrun` per cell
# (arch, shape, multi-pod), each in a process of its own, and the plan fields
# that JAX's make_plan gives on its mesh (tests/test_torch_sharding_plan.py
# holds the port's plan to JAX's for every arch and mesh).  The last five
# cells are the ones the sharding repairs changed most: the kv projection
# of a cache-emitting prefill (phi3.5-moe's raised before), the B/C cut and
# the SSD's train steps, these in one microbatch (``--accum 1``: the same
# per-device FLOPs in JAX's records, traced 8 times faster).
DRYRUN_CELLS = [("internlm2-1.8b", "train_4k", False), ("internlm2-1.8b", "decode_32k", False),
                ("phi3.5-moe-42b-a6.6b", "train_4k", False),
                ("phi3.5-moe-42b-a6.6b", "decode_32k", False),
                ("internlm2-1.8b", "train_4k", True), ("mamba2-1.3b", "prefill_32k", False),
                ("phi3.5-moe-42b-a6.6b", "prefill_32k", False),
                ("jamba-1.5-large-398b", "prefill_32k", False),
                ("mamba2-1.3b", "train_4k", False, 1),
                ("jamba-1.5-large-398b", "train_4k", False, 1),
                ("internlm2-1.8b", "prefill_32k", False)]
DRYRUN_PLANS = {
    "internlm2-1.8b": dict(H=16, K=8, V=94208, kv_sharded=False, head_pad_overhead=0.0),
    "phi3.5-moe-42b-a6.6b": dict(H=32, K=8, V=32768, kv_sharded=False, head_pad_overhead=0.0),
    "mamba2-1.3b": dict(H=0, K=0, V=51200, kv_sharded=False, head_pad_overhead=0.0),
    "jamba-1.5-large-398b": dict(H=64, K=8, V=65536, kv_sharded=False, head_pad_overhead=0.0),
}
# JAX's records of these cells, made by its own dry run on the CPU
# (tests/data/jax_dryrun_records.jsonl); each cell's per-device FLOPs must
# equal JAX's but for what analysis.parity derives, and the decode cell's
# collectives stay within twice JAX's
JAX_RECORDS = ROOT / "tests" / "data" / "jax_dryrun_records.jsonl"
DECODE_COLLECTIVES_X = 2


# seconds each dry-run process may take (the slowest, phi3.5-moe train_4k
# with 8 microbatches, took 68-97 s beside the others; jamba train_4k in one
# microbatch 53-61 s beside the others on the card's 8-core host)
DRYRUN_TIMEOUT_S = 600


def start_dryrun():
    """Phase 14 (b), started after every timed phase: one dry-run process
    per cell, all at once, each on one thread (host CPU only: meta tensors,
    a fake process group)."""
    import os
    import shutil
    out = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for i, (arch, shape, multi_pod, *accum) in enumerate(DRYRUN_CELLS):
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                "--shape", shape, "--out", str(out / f"{i}.jsonl")] + (
                    ["--multi-pod"] if multi_pod else []) + (
                    ["--accum", str(accum[0])] if accum else [])
        with open(out / f"{i}.log", "w") as log_file:
            procs.append(subprocess.Popen(argv, env=env, cwd=str(ROOT), stdout=log_file,
                                          stderr=subprocess.STDOUT))
    return {"procs": procs, "t0": time.perf_counter()}


def _jax_dryrun_record(arch, shape, mesh, accum):
    with open(JAX_RECORDS) as f:
        for line in f:
            r = json.loads(line)
            if (r["arch"], r["shape"], r["mesh"], r.get("accum_steps")) == (arch, shape, mesh, accum):
                return r
    fail(f"no JAX record of {arch} x {shape} x {mesh} ({accum} microbatches) in {JAX_RECORDS}")


def _parity_delta(arch, shape, multi_pod, accum):
    """analysis.parity's port-minus-JAX FLOPs of a full-width cell."""
    from repro_torch.analysis.parity import cell_delta
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.sharding.plan import make_abstract_mesh, make_plan
    cfg = get_config(arch)
    plan = make_plan(cfg, make_abstract_mesh(*production_mesh_shape(multi_pod)))
    return cell_delta(cfg, SHAPES[shape], plan, accum or 1)


def finish_dryrun(state):
    """Phase 14 (b): every cell's record must be ok, its per-device FLOPs
    JAX's record's plus ``analysis.parity``'s derived difference, the
    data-parallel train cells must all-reduce, the decode cell's
    collectives stay within ``DECODE_COLLECTIVES_X`` of JAX's, and the plan
    fields must be JAX's.  Returns the ``dryrun`` line's body."""
    try:
        for proc in state["procs"]:
            proc.wait(timeout=max(DRYRUN_TIMEOUT_S - (time.perf_counter() - state["t0"]), 1))
    except subprocess.TimeoutExpired as e:
        fail(f"dry run: a cell ran past {DRYRUN_TIMEOUT_S} s ({e.cmd[3:]})")
    finally:
        for proc in state["procs"]:
            proc.kill()
            proc.wait()
    out = ROOT / "build" / "chip_smoke_dryrun"
    cells = []
    for i, (arch, shape, multi_pod, *accum) in enumerate(DRYRUN_CELLS):
        path = out / f"{i}.jsonl"
        if not path.is_file():
            fail(f"dry run {arch} x {shape}: no record; log: "
                 f"{(out / f'{i}.log').read_text()[-2000:]}")
        rec = json.loads(path.read_text().splitlines()[-1])
        if rec["status"] != "ok":
            fail(f"dry run {arch} x {shape} multi_pod={multi_pod}: {rec.get('error')}\n"
                 f"{rec.get('traceback', '')}")
        t = rec["roofline"]
        jt = _jax_dryrun_record(arch, shape, rec["mesh"], rec["accum_steps"])["roofline"]
        delta = _parity_delta(arch, shape, multi_pod, rec["accum_steps"])
        if not (t["hlo_flops"] > 0 and t["hlo_flops"] - jt["hlo_flops"] == delta):
            fail(f"dry run {arch} x {shape} x {rec['mesh']}: FLOPs {t['hlo_flops']}, "
                 f"want JAX's {jt['hlo_flops']} + {delta}")
        if shape == "decode_32k" and not (
                t["collective_bytes"] <= DECODE_COLLECTIVES_X * jt["collective_bytes"]):
            fail(f"dry run {arch} x {shape}: collectives {t['collective_bytes']} B, JAX's "
                 f"{jt['collective_bytes']} B")
        if shape == "train_4k" and "all-reduce" not in t["collective_detail"]:
            fail(f"dry run {arch} x {shape}: collectives {sorted(t['collective_detail'])}, "
                 "want an all-reduce (data-parallel gradients)")
        if rec["plan"] != DRYRUN_PLANS[arch]:
            fail(f"dry run {arch}: plan {rec['plan']}, want JAX's {DRYRUN_PLANS[arch]}")
        cells.append({"arch": arch, "shape": shape, "mesh": rec["mesh"],
                      "trace_s": rec["trace_s"], "accum_steps": rec["accum_steps"],
                      "flops_per_device": t["hlo_flops"], "jax_flops": jt["hlo_flops"],
                      "derived_delta": delta, "jax_collective_bytes": jt["collective_bytes"],
                      "hbm_bytes": t["hbm_bytes"],
                      "collective_bytes": t["collective_detail"], "dominant": t["dominant"],
                      "compute_s": t["compute_s"], "memory_s": t["memory_s"],
                      "collective_s": t["collective_s"],
                      "roofline_fraction": t["roofline_fraction"],
                      "peak_estimate_bytes": rec["memory_analysis"]["peak_estimate_bytes"],
                      "traffic_by_tag": rec["traffic_by_tag"], "device": rec["device"]})
        log(f"dry run {arch} x {shape} x {rec['mesh']}: ok, trace {rec['trace_s']} s, "
            f"{t['hlo_flops']:.4g} FLOPs/device, dominant {t['dominant']}")
    return {"cells": cells, "phase_s": time.perf_counter() - state["t0"]}


def _k1_plain_rows(q, k, v, causal=True, block=2048):
    """K1's plain version (``attention_ref``'s arithmetic: GQA by repeat,
    f32 scores, mask, softmax, f32 p.v) a block of query rows at a time, so
    that S = 32,768 needs no [S, S] score matrix."""
    import torch
    B, H, Sq, hd = q.shape
    g = H // k.shape[1]
    kf = torch.repeat_interleave(k, g, dim=1).float()
    vf = torch.repeat_interleave(v, g, dim=1).float()
    out = torch.empty_like(q)
    k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
    for r0 in range(0, Sq, block):
        r1 = min(r0 + block, Sq)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(), kf) * hd ** -0.5
        if causal:
            q_pos = torch.arange(r0, r1, device=q.device)[:, None]
            s = torch.where(k_pos <= q_pos, s, -1e30)
        out[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                                        vf).to(q.dtype)
    return out


def check_cell_shapes():
    """Phase 14 (a), kernels: K1 and K2 at the prefill_32k cells' shapes
    against their plain versions (bf16 tolerances, each output row also
    within the tolerance of its norm, as phase 11 (e); K1's "tc" kernel
    too, where "wg" serves), then timed (the plain K1 a block of rows at a
    time, ``_k1_plain_rows``)."""
    import torch
    from repro_torch.kernels.flash_attention import (_launch, flash_attention_hmajor,
                                                     k1_variant)
    from repro_torch.kernels.ssd_scan import ssd_scan_hmajor, ssd_scan_hmajor_plain
    out = []
    for i, (label, kernel, shape, _, _) in enumerate(CELL_SHAPES):
        tol = KERNEL_TOL[(kernel, "bfloat16")]
        tc_held = None
        if kernel == "K1":
            q, k, v = _qkv(shape["B"], shape["Sq"], shape["Skv"], shape["H"], shape["K"],
                           shape["hd"], torch.bfloat16, seed=400 + i)
            ref = _k1_plain_rows(q, k, v, causal=True)
            pairs = [(flash_attention_hmajor(q, k, v, causal=True), ref)]
            if k1_variant(q.dtype, shape["hd"]) == "wg":
                tc = _launch(q, k, v, "tc", **_K1_DEFAULTS)
                torch.cuda.synchronize()
                tc_held = _hold(f"{label} [tc]", [(tc, ref)], tol, rows=True)
                del tc
            del q, k, v, ref
        else:
            x, dt_, A, Bi, Ci = _ssd_inputs(shape["B"], shape["S"], shape["H"], shape["G"],
                                            shape["P"], shape["N"], torch.bfloat16,
                                            seed=400 + i, serve=True)
            pairs = list(zip(ssd_scan_hmajor(x, dt_, A, Bi, Ci),
                             ssd_scan_hmajor_plain(x, dt_, A, Bi, Ci, chunk=256)))
            del x, dt_, A, Bi, Ci
        torch.cuda.synchronize()
        held = _hold(label, pairs, tol, rows=True)
        del pairs
        torch.cuda.empty_cache()
        if kernel == "K1":
            t = time_k1_at(shape["B"], shape["Sq"], shape["Skv"], shape["H"], shape["K"],
                           shape["hd"], causal=True, seed=410 + i, fma_calls=3,
                           plain=_k1_plain_rows)
        else:
            t = time_k2_at(shape["B"], shape["S"], shape["H"], shape["G"], shape["P"],
                           shape["N"], seed=410 + i, variants=False, sweep=K2_SEGMENT_SWEEP)
        entry = {"name": label, "shape": shape, **held,
                 **({"tc": tc_held} if tc_held else {}),
                 **{k: t[k] for k in _TIME_KEYS + ("flops", "bytes") if k in t}}
        torch.cuda.empty_cache()
        log(f"{label}: {json.dumps(entry)}")
        out.append(entry)
    return out


def _cell_ms(cell, n=3):
    """Warm time of one run of ``cell``: the median of ``n`` runs, each
    between two CUDA events."""
    import torch
    times = []
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        cell.run()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def run_cell_on_card(arch, shape, batch, overrides, want, card):
    """Phase 14 (a), one cell: built on a 1x1 mesh on the card, run once with
    the launch counts set to 0 just before and read just after (held to
    ``want``), logits finite, the warm time, the account of the same call
    against the meta dry run of the same 1x1 cell (equal FLOPs), and the
    roofline terms with the card's own constants."""
    import torch
    from repro_torch.analysis.account import account
    from repro_torch.analysis.roofline import build_terms
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_mesh
    kw = dict(global_batch=batch, overrides=overrides)
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, make_mesh((1, 1), ("data", "model"), "cuda"),
                      device="cuda", seed=0, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    want = {k: {(_k2_variant_of(cell.lm.cfg) if v == "k2_variant" else v): n
                for v, n in by.items()} for k, by in want.items()}
    torch.cuda.reset_peak_memory_stats()
    wrappers = _reset_launches()
    out = cell.run()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    by_variant = {k: dict(w.launches_by_variant) for k, w in wrappers.items()}
    launched = {k: {v: n for v, n in by.items() if n} for k, by in by_variant.items()}
    if launched != want or any(launches[k] != sum(want[k].values()) for k in want):
        fail(f"cell {arch} x {shape}: launches {by_variant}, want {want}")
    logits = out["logits"] if cell.kind == "prefill" else out[0]
    B = cell.shape.global_batch
    if tuple(logits.shape[:2]) != (B, 1) or not torch.isfinite(logits.float()).all():
        fail(f"cell {arch} x {shape}: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits.float()).all())}")
    del out, logits
    warm_ms = _cell_ms(cell)
    peak = torch.cuda.max_memory_allocated()
    _, acct = account(cell.run)
    torch.cuda.synchronize()
    meta = build_cell(arch, shape, make_mesh((1, 1), ("data", "model"), "meta"),
                      device="meta", **kw)
    _, meta_acct = account(meta.run)
    if acct.flops != meta_acct.flops or acct.flops <= 0:
        fail(f"cell {arch} x {shape}: the card's account counts {acct.flops} FLOPs, the "
             f"meta dry run of the same 1x1 cell {meta_acct.flops}")
    terms = build_terms(arch, cell.lm.cfg, cell.shape, "1x1", 1, acct, peak,
                        device=torch.cuda.get_device_name(0))
    entry = {"arch": arch, "shape": shape, "batch": B, "seq": cell.shape.seq_len,
             "kv_cache_dtype": cell.shape.kv_cache_dtype, "overrides": overrides,
             "launches": launches, "launches_by_variant": launched, "build_s": build_s,
             "warm_ms": warm_ms,
             "peak_gb": peak / 1e9, "flops": acct.flops, "meta_flops": meta_acct.flops,
             "traffic_bytes": acct.traffic_bytes, "traffic_by_tag": acct.traffic_by_tag,
             "kernel_calls": acct.kernel_calls, "compute_s": terms.compute_s,
             "memory_s": terms.memory_s, "step_time_s": terms.step_time_s,
             "dominant": terms.dominant, "model_flops": terms.model_flops_total,
             "useful_flops_fraction": terms.useful_flops_fraction,
             "roofline_fraction": terms.roofline_fraction,
             "achieved_fraction": terms.fraction_at(warm_ms / 1e3),
             "bound_share": terms.step_time_s / (warm_ms / 1e3), "card": card}
    log(f"cell {arch} x {shape} (batch {B}) on {card}: {warm_ms:.1f} ms warm, "
        f"{acct.flops:.4g} FLOPs (meta {meta_acct.flops:.4g}), bound "
        f"{terms.step_time_s * 1e3:.2f} ms ({terms.dominant}), roofline_fraction "
        f"{terms.roofline_fraction:.4f}, achieved {entry['achieved_fraction']:.4f}")
    del cell, meta
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def run_cells_phase(card):
    """Phase 14 (a): the kernels at the cells' shapes, then each cell."""
    t0 = time.perf_counter()
    shapes = check_cell_shapes()
    cells = [run_cell_on_card(*c, card=card) for c in CELL_RUNS]
    return {"cells": cells, "shapes": shapes, "card": card,
            "phase_s": time.perf_counter() - t0}


def main():
    t_start = time.perf_counter()
    card = check_device()
    sys.path.insert(0, str(SRC))
    import torch

    build_s = build_kernels()
    occupancy = kernel_occupancy()
    k1_err, k1_share = check_k1()
    (k2_err, k2_share), k2_rounding_split = check_k2()

    res, k1_launches, serve_variants = run_serve()
    checks = check_serve(res)
    serve = _serve_times(res, time_prefill(res.lm, res.prompts), checks)
    del res
    k1 = time_k1()

    torch.cuda.empty_cache()
    res, k2_launches, ssm_variants = run_ssm_serve()
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

    t_fam = time.perf_counter()
    torch.cuda.empty_cache()
    families = {name: run_family(name) for name in FAMILY_RUNS}
    new_shapes = check_new_shapes()
    print(json.dumps({"families": {**families, "card": card,
                                   "phase_s": time.perf_counter() - t_fam}}))
    torch.cuda.empty_cache()
    train_line, train_launches = run_train_phase()
    print(json.dumps({"train": {**train_line, "card": card}}))
    torch.cuda.empty_cache()
    bench_line, bench_launches, sb_launches = run_bench_phase()
    print(json.dumps({"bench": {**bench_line, "card": card}}))
    torch.cuda.empty_cache()
    cells_line = run_cells_phase(card)
    print(json.dumps({"cells": cells_line}))
    # phase 14 (b) on the host, after the last timed phase
    print(json.dumps({"dryrun": finish_dryrun(start_dryrun())}))
    cell_launches = {k: {f"{c['arch']}|{c['shape']}": c["launches"][k]
                         for c in cells_line["cells"]} for k in ("K1", "K2")}
    cell_shapes = {k: [e for e in cells_line["shapes"] if e["name"].startswith(k)]
                   for k in ("K1", "K2")}

    times = {
        "card": card,
        "build_s": build_s,
        "occupancy": occupancy,
        "k1_serve_shape": {"max_abs_err": k1_err, "tolerance_share": k1_share,
                           **{k: k1[k] for k in _TIME_KEYS + ("flops", "bytes") if k in k1}},
        "k2_serve_shape": {"max_abs_err": k2_err, "tolerance_share": k2_share,
                           "rounding": k2_rounding_split,
                           **{k: k2[k] for k in _TIME_KEYS + (
                               "bf16_operands_ms", "bf16_operands_device_ms", "flops",
                               "bytes") if k in k2}},
        "serve": serve,
        "ssm_serve": ssm_serve,
        "wall_s": time.perf_counter() - t_start,
    }
    print(json.dumps({"times": times}))
    fam_launches = {k: {name: f["launches"][k] for name, f in families.items()}
                    for k in ("K1", "K2")}
    shapes = {k: [e for e in new_shapes if e["name"].startswith(k)] + cell_shapes[k]
              for k in ("K1", "K2")}
    print(json.dumps({"kernels": [
        _kernel_line("K1 flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:32", k1_launches,
                     serve_variants["K1"], duet_launches["K1"], cli_launches["K1"], obs_launches["K1"], k1_err, k1,
                     fam_launches["K1"], shapes["K1"], train_launches["K1"],
                     bench_launches["K1"], {a: n["K1"] for a, n in sb_launches.items()},
                     cell_launches["K1"]),
        _kernel_line("K2 ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:31", k2_launches,
                     ssm_variants["K2"], duet_launches["K2"], cli_launches["K2"], obs_launches["K2"], k2_err, k2,
                     fam_launches["K2"], shapes["K2"], train_launches["K2"],
                     bench_launches["K2"], {a: n["K2"] for a, n in sb_launches.items()},
                     cell_launches["K2"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
