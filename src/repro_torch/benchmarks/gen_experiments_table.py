"""Emit the EXPERIMENTS.md §Roofline markdown table from dry-run JSONL: the
twin of the JAX package's ``benchmarks/gen_experiments_table.py``, over the
port's plan and ``analysis.variants``.

    PYTHONPATH=src python -m repro_torch.benchmarks.gen_experiments_table results/dryrun_torch.jsonl
"""
import sys

from repro_torch.benchmarks.roofline_table import DEFAULT_PATH, load_records


def fused_adjust(r):
    """fused-kernel (K1 / K2 deployment) adjusted memory seconds."""
    from repro_torch.analysis.variants import adjusted_memory_term
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch.mesh import make_abstract_mesh, production_mesh_shape
    from repro_torch.sharding.plan import make_plan
    if not r.get("traffic_by_tag"):
        return None
    cfg = get_config(r["arch"])
    plan = make_plan(cfg, make_abstract_mesh(*production_mesh_shape(r["mesh"] == "2x16x16")))
    return adjusted_memory_term(r, plan, cfg, SHAPES[r["shape"]])


def main(path=DEFAULT_PATH):
    recs = [r for r in load_records(path) if not r.get("overrides")]
    print("| arch | shape | mesh | compute s | memory s | collective s | "
          "dominant | peak GiB/dev | useful % | MFU-bound % |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        name = f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
        if r["status"] == "skipped":
            print(f"{name} — | — | — | SKIP (full attention @500k) | — | — | — |")
            continue
        if r["status"] != "ok":
            print(f"{name} ERROR {r.get('error','')[:40]} |")
            continue
        t = r["roofline"]
        peak = (r["memory_analysis"] or {}).get("peak_estimate_bytes", 0) / 2**30
        print(f"{name} {t['compute_s']:.2f} | {t['memory_s']:.2f} | "
              f"{t['collective_s']:.2f} | {t['dominant']} | {peak:.1f} | "
              f"{t['useful_flops_fraction']*100:.0f} | "
              f"{t['roofline_fraction']*100:.2f} |")


if __name__ == "__main__":
    main(*sys.argv[1:])
