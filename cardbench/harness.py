"""The benchmark of the port: one run of one cell, driven by data.

``run.py`` calls ``main``.  A cell of ``BENCHMARK.json`` names a
configuration (its file) and a traffic mix (``traffic/<name>.json``); the
configuration's family is ``families/<family>.py`` with its reference
``reference/<family>.py``; each metric is read by ``metrics/<name>.py``; a
cell's limits on the output check are in ``limits/<cell>.json``.  A later
change adds a family, a configuration, a mix, a metric or a cell as files
of its own and edits none of these.

A run: draw the weights from the seed, build the program with them, warm
up every shape of the mix, then serve the mix in a closed loop for whole
cycles until ``--seconds`` have passed (no cycle starts after that, and the
cycle in flight finishes, so every seed serves the same set of sizes).  The
window's rates divide by its actual length.  Then the output check, then
one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from cardbench import check, families, port, weights, yardstick
from cardbench.traffic import Batch, Mix, sub_seed

BENCH = Path(__file__).resolve().parent.name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_TOKENS = 3


class Refused(Exception):
    """A run that must print no result (exit code ``code``)."""

    def __init__(self, msg, code=2):
        super().__init__(msg)
        self.code = code


@dataclass
class BatchRecord:
    batch: Batch
    prompts: object             # [size, prompt] token ids on the device
    t0: float = 0.0             # host clock when the batch was sent
    stamps: list = field(default_factory=list)   # host clock of each token
    tokens: object = None       # [size, output] ids on the host


@dataclass
class RunData:
    """What a metric's reader reads."""
    workload: str
    cfg: dict
    mix: Mix
    card: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: int = 0
    records: list = field(default_factory=list)
    trace: object = None        # trace.TraceData of a traced run


# ------------------------------------------------------------------ spec
def load_cell(root: Path, workload: str):
    """(cell, configuration, mix, metric entries by trace flag, limits)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}", 1)
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = families.at_root(json.loads((root / config["file"]).read_text()), root)
    missing = [str(p.relative_to(root)) for p in families.files(cfg) if not p.is_file()]
    if missing:
        raise Refused(f"{workload}: family {cfg['family']!r} of {cell['config']} has no "
                      f"{' and no '.join(missing)}", 1)
    mix = Mix.load(root / BENCH / "traffic" / f"{cell['traffic']}.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    metrics = {0: [m for m in spec["end_to_end"] if mine(m)],
               1: [m for m in spec["per_layer"] if mine(m)]}
    limits_file = root / BENCH / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.is_file() else {}
    return cell, cfg, mix, metrics, limits


def reader(root: Path, name: str):
    """The ``read`` of the metric file ``metrics/<name>.py``."""
    return families.load_file(root / BENCH / "metrics" / f"{name}.py", "metric").read


# ---------------------------------------------------------------- serving
def pick(logits):
    """Greedy: the token [B, 1] the logits rank first, on the device."""
    import torch
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


def serve_batch(lm, cfg, mix, seed, batch, tracer=None):
    """One batch through the program, as ``repro_torch.launch.serve.run``
    serves it: prefill, grow the cache, greedy decode.  Each token is copied
    to the host as it is made and stamped on the host clock."""
    import torch
    from repro_torch.launch.serve import grow_cache
    rec = BatchRecord(batch, mix.prompts(seed, batch, cfg["vocab_size"], lm.device))
    traced = tracer is not None and batch.cycle == 0
    if traced:
        tracer.start()
    span = tracer.range if tracer is not None else _no_range
    kv = cfg.get("kv_dtype", "bfloat16")
    host, logits = [], None
    with torch.inference_mode():
        rec.t0 = time.perf_counter()
        with span("prefill", {"batch": batch.size, "prompt": batch.prompt}):
            out = lm.forward(rec.prompts, mode="prefill", kv_dtype=kv)
        with span("grow_cache"):
            cache = grow_cache(lm.cfg, out["cache"], batch.prompt + batch.output)
        tok = pick(out["logits"])
        del out
        host.append(tok.cpu())
        rec.stamps.append(time.perf_counter())
        for i in range(batch.output - 1):
            with span("decode", {"batch": batch.size, "pos": batch.prompt + i}):
                logits, cache = lm.decode(cache, tok, batch.prompt + i)
            tok = pick(logits)
            host.append(tok.cpu())
            rec.stamps.append(time.perf_counter())
            if traced and i + 1 == tracer.decode_steps:
                tracer.stop()
        del cache, logits
    if traced:
        tracer.stop()
    rec.tokens = torch.cat(host, dim=1).numpy()
    return rec


@contextlib.contextmanager
def _no_range(name, meta=None):
    yield


def warm_up(lm, cfg, mix, seed):
    """Every (prompt, output) shape of the mix once, a few tokens each."""
    for k, (prompt, output) in enumerate(mix.shapes()):
        b = Batch(-1 - k, -1, prompt, min(output, WARM_TOKENS), mix.batch)
        serve_batch(lm, cfg, mix, sub_seed(seed, 4), b)


def window(lm, cfg, mix, seed, seconds, tracer=None):
    """Whole cycles of the mix until ``seconds`` have passed; returns the
    batch records and the window's length."""
    records, cycle = [], 0
    t0 = time.perf_counter()
    while cycle == 0 or time.perf_counter() - t0 < seconds:
        for b in mix.cycle(seed, cycle, len(records)):
            records.append(serve_batch(lm, cfg, mix, seed, b, tracer))
        cycle += 1
    return records, time.perf_counter() - t0


# ------------------------------------------------------------------- run
def launches():
    from repro_torch.kernels.flash_attention import flash_attention_hmajor
    from repro_torch.kernels.ssd_scan import ssd_scan_hmajor
    return {"k1": dict(flash_attention_hmajor.launches_by_variant),
            "k2": dict(ssd_scan_hmajor.launches_by_variant)}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg):
    print(f"[cardbench] {msg}", flush=True)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start=None):
    """One run of ``workload``; returns the result object."""
    t_start = time.perf_counter() if t_start is None else t_start
    _, cfg, mix, metrics, limits = load_cell(root, workload)
    import torch
    from cardbench.trace import Tracer
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    card_name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    card = yardstick.peaks(card_name) if on_card else {"bf16_flops": math.nan,
                                                        "bytes_per_s": math.nan}
    if on_card:
        log(f"card {card_name}; nvidia-smi name, power limit: {power_limit()}")
    w = weights.draw(cfg, sub_seed(seed, 0), dev)
    lm = port.build(cfg, w)
    tracer = None
    if trace:
        tracer = Tracer(torch, on_card)
        tracer.install()
    try:
        warm_up(lm, cfg, mix, seed)
        if tracer is not None and on_card:     # the profiler's own first start
            tracer.start()
            tracer.stop()
            tracer.data = type(tracer.data)()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = launches()
        run = RunData(workload, cfg, mix, card, setup_s=time.perf_counter() - t_start)
        run.records, run.window_s = window(lm, cfg, mix, seed, seconds, tracer)
        if on_card:
            run.peak_bytes = torch.cuda.max_memory_allocated()
    finally:
        if tracer is not None:
            tracer.uninstall()
    after = launches()
    run.trace = tracer.data if tracer is not None else None
    n_req = sum(r.batch.size for r in run.records)
    log(f"window {run.window_s:.3f} s: {len(run.records)} batches, {n_req} requests; "
        f"set-up {run.setup_s:.3f} s; peak {run.peak_bytes} B")
    gaps = sorted((b - a) * 1e3 for r in run.records for a, b in zip(r.stamps, r.stamps[1:]))
    if gaps:
        log("gaps between tokens (ms; each step once): " + ", ".join(
            f"p{q} {yardstick.percentile(gaps, q):.3f}" for q in (50, 90, 95, 99, 100)))
    log("launches in the window: " + json.dumps(
        {k: {v: after[k][v] - before[k][v] for v in after[k]} for k in after}))

    values = {}
    for m in metrics[int(trace)]:
        v = reader(root, m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        log(f"traced {run.trace.window_s:.3f} s of the window, device busy "
            f"{run.trace.busy_s:.3f} s")

    # the output check, once the window's state is freed
    del lm
    if on_card:
        torch.cuda.empty_cache()
    V = cfg["vocab_size"]
    failed = sum(int(((r.tokens < 0) | (r.tokens >= V)).any(axis=1).sum()
                     + (r.tokens.shape[1] != r.batch.output) * r.batch.size)
                 for r in run.records)
    t_check = time.perf_counter()
    served, _ = check.gaps(w, cfg, check.sample(run.records, mix.check_requests, seed))
    max_gap = float(max(g.max() for g in served))
    log(f"output check: {sum(len(g) for g in served)} tokens of {len(served)} requests "
        f"in {time.perf_counter() - t_check:.3f} s")
    limit = limits.get("max_gap", {}).get("limit")
    checks = {"max_gap": {"value": max_gap, "limit": limit},
              "failed": {"value": failed, "limit": 0}}
    correct = (limit is not None and max_gap <= limit and failed == 0
               and all(math.isfinite(v["value"]) for v in values.values()))

    device_info = {"platform": "gpu" if on_card else "cpu", "kind": card_name, "count": 1,
                   "memory_peak_bytes": run.peak_bytes}
    result = {"correct": bool(correct), "attempted": n_req, "failed": failed,
              "metrics": values, "device": device_info}
    if trace:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start=None, root=None):
    """The command: one run of a cell of the checkout at ``root`` (the one
    this file lies in)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    root = Path(root) if root is not None else Path(__file__).resolve().parents[1]
    try:
        if not (root / "src" / "repro_torch").is_dir():
            raise Refused(f"the program (src/repro_torch) is not in {root}", 1)
        cell = load_cell(root, args.workload)[0]
        import torch
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: this benchmark runs only on the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{args.workload} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} present")
        result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
        bad = forbidden_modules()
        if bad:
            raise Refused(f"modules loaded in the run: {bad} (jax or the JAX package)", 3)
    except Refused as e:
        print(f"[cardbench] refused: {e}", file=sys.stderr, flush=True)
        return e.code
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
