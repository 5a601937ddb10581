"""The multi-pod dry run: the counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \
        --shape decode_32k --out results/dryrun_torch.jsonl

Each (arch x shape x mesh) cell is built by ``launch/cells.py`` at full
width on the meta device over the production mesh, whose 256 (16x16) or 512
(2x16x16) devices are the ranks of a fake process group
(``launch.mesh.fake_process_group``, started and stopped around each cell):
the parameters, optimizer state, caches and batch are meta DTensors placed
by the sharding plan, nothing is allocated and no data moves.  The step
runs once on them under ``analysis.account.Account``, which counts its
per-device FLOPs, HBM traffic and collective bytes; ``analysis.roofline``
turns those into the record's roofline terms for the card named by
``--roofline-device`` (default the H100 SXM).

Each JSONL record has the JAX record's keys, with one rename and one
addition: ``trace_s`` (the seconds to build the cell and run it on the meta
device) takes the place of ``lower_s``/``compile_s``, and ``device`` names
the card the roofline was reckoned for.  ``memory_analysis`` is per device:
``argument_bytes`` the local shards of the parameters, optimizer state,
caches and inputs; ``output_bytes`` those of the outputs; ``alias_bytes``
the outputs that are arguments updated in place (the train state, the
decode cache); ``temp_bytes`` the peak, over the run, of the bytes of the
tensors the step created and had not freed yet (a finalizer on each, see
account.py), less the new outputs; ``peak_estimate_bytes`` = argument +
output - alias + temp, JAX's sum.  ``cost_analysis`` holds the account's
own "flops", "bytes accessed" and "transcendentals" (the port has no XLA
cost analysis).  XLA's counts each while loop's body once (a scanned layer
stack, an accumulation loop, a chunk loop), where the account counts every
execution: the two agree when every loop runs once
(tests/test_torch_transcendentals.py).  JAX's CPU records also carry
"optimal_seconds" (-1.0 or -2.0 there), which has no counterpart.
Exit 1 on any error, as JAX's does.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import torch

from repro_torch.analysis.account import account
from repro_torch.analysis.roofline import DEFAULT_DEVICE, build_terms
from repro_torch.configs.base import SHAPES, get_config, shape_applicable
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import (fake_process_group, make_production_mesh,
                                     production_mesh_shape)
from repro_torch.train.tree import leaves

SKIP_REASON = "sub-quadratic shape on full-attention arch (DESIGN.md §6)"


def _local_bytes(tree) -> int:
    """Per-device bytes of the tensors of a nest (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def memory_estimate(cell, out, peak_live: float) -> dict:
    """The record's ``memory_analysis`` (see the module docstring)."""
    params = _local_bytes(list(cell.lm.parameters()))
    if cell.kind == "train":
        state, batch = cell.args
        args = _local_bytes(state["opt"]) + _local_bytes(batch) + params
        alias = _local_bytes(state["opt"]) + params
        output = alias + _local_bytes(out[1])
    elif cell.kind == "prefill":
        args = params + _local_bytes(cell.args)
        output = _local_bytes(out)
        alias = 0
    else:
        cache, token, _ = cell.args
        args = params + _local_bytes(cache) + _local_bytes(token)
        output = _local_bytes(out)
        alias = _local_bytes(cache)
    temp = max(peak_live - (output - alias), 0)
    return {"argument_bytes": args, "output_bytes": output, "alias_bytes": alias,
            "temp_bytes": temp, "peak_estimate_bytes": args + output - alias + temp}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, accum=None,
             overrides=None, verbose: bool = True,
             roofline_device: str = DEFAULT_DEVICE) -> dict:
    """Build one (arch x shape x mesh) cell on meta DTensors and run it once
    under the account; return the record."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cfg = get_config(arch)
    overrides = dict(overrides) if overrides else None
    # nested-config override shorthands (hillclimb knobs)
    nested = {}
    for key in ("capacity_factor", "ssm_chunk", "state_bits"):
        if overrides and key in overrides:
            nested[key] = overrides.pop(key)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "multi_pod": multi_pod,
           "overrides": {**(overrides or {}), **nested}}
    if not shape_applicable(cfg, shape):
        rec.update(status="skipped", reason=SKIP_REASON)
        return rec
    t0 = time.time()
    try:
        if nested:
            import dataclasses
            overrides = dict(overrides or {})
            if "capacity_factor" in nested:
                overrides["moe"] = dataclasses.replace(
                    cfg.moe, capacity_factor=nested["capacity_factor"])
            if "ssm_chunk" in nested:
                overrides["ssm"] = dataclasses.replace(
                    cfg.ssm, chunk_size=nested["ssm_chunk"])
        ocfg = None
        if "state_bits" in nested:
            from repro_torch.train.optimizer import OptimizerConfig
            ocfg = OptimizerConfig(state_bits=nested["state_bits"])
        with fake_process_group(math.prod(production_mesh_shape(multi_pod)[0])):
            mesh = make_production_mesh(multi_pod=multi_pod)
            cell = build_cell(arch, shape_name, mesh, accum=accum,
                              overrides=overrides, ocfg=ocfg)
            out, acct = account(cell.run, track_memory=True)
            mem = memory_estimate(cell, out, acct.peak_live_bytes)
            del out
            t_trace = time.time() - t0
            terms = build_terms(arch, cell.lm.cfg, shape, mesh_name, mesh.size(), acct,
                                mem["peak_estimate_bytes"], device=roofline_device)
        rec.update(
            status="ok", trace_s=round(t_trace, 1), device=roofline_device,
            accum_steps=cell.accum_steps,
            plan={"H": cell.plan.H, "K": cell.plan.K, "V": cell.plan.V,
                  "kv_sharded": cell.plan.kv_sharded,
                  "head_pad_overhead": cell.plan.head_pad_overhead},
            memory_analysis=mem,
            cost_analysis={"flops": acct.flops, "bytes accessed": acct.traffic_bytes,
                           "transcendentals": acct.transcendentals},
            roofline=terms.to_dict(),
            traffic_by_tag=dict(acct.traffic_by_tag),
        )
        if verbose:
            peak = mem["peak_estimate_bytes"] / 2**30
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
                  f"trace {t_trace:.0f}s peak/dev {peak:.2f} GiB "
                  f"dominant={terms.dominant} "
                  f"(c={terms.compute_s*1e3:.1f}ms m={terms.memory_s*1e3:.1f}ms "
                  f"x={terms.collective_s*1e3:.1f}ms)", flush=True)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
                  f"FAILED {type(e).__name__}: {e}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Multi-pod dry run: build and run every (arch x shape x "
                    "mesh) cell on meta DTensors over a fake process group.")
    ap.add_argument("--arch", default=None, help="single arch (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--roofline-device", default=DEFAULT_DEVICE,
                    help="the card the roofline is reckoned for (a name of "
                         "analysis.roofline's table)")
    args = ap.parse_args(argv)

    from repro_torch.configs.all_configs import ARCH_IDS
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, multi_pod=multi_pod,
                               accum=args.accum, roofline_device=args.roofline_device)
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
