"""Helpers of the gloo workers that hold the port's sharded model to one
device: four CPU processes on localhost, each running a worker script that
imports this module (the tests directory is on its path)."""
import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(__file__)


def run_workers(script, world=4, timeout=600):
    """Run ``script`` as ``world`` processes (argv: rank, port) in one gloo
    group on localhost; every process must exit 0; returns the JSON of rank
    0's last line."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"), HERE]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        finally:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


# ------------------------------------------------------ inside a worker
def init(world=4):
    import torch.distributed as dist
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return rank


def one_device(cfg, nudge=None):
    """The seeded weights on one device; ``nudge``: every weight moved by one
    float32 rounding step (x (1 +- 2**-24)), as test_torch_lm_families
    does, to measure the reference's own noise floor."""
    import numpy as np
    import torch
    from repro_torch.models.lm import LM
    one = LM(cfg, device="cpu", seed=3).float()
    if nudge is not None:
        signs = np.random.default_rng(nudge)
        with torch.no_grad():
            for p in one.parameters():
                p.mul_(1 + 2.0 ** -24 * torch.from_numpy(
                    signs.choice(np.array([-1, 1], np.float32), p.shape)))
    return one


def on_mesh(cfg, plan, one):
    """``one``'s weights placed on the mesh (padded vocab rows zero)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.lm import LM
    lm = LM(cfg, plan, device="cpu").float()
    with torch.no_grad():
        for p, q in zip(lm.parameters(), one.parameters()):
            w = torch.zeros(p.shape)
            w[tuple(slice(0, n) for n in q.shape)] = q
            p.copy_(distribute_tensor(w, p.device_mesh, p.placements))
    return lm


def whole(a, b):
    """``a`` from the mesh as a whole tensor, cut to ``b``'s shape."""
    from torch.distributed.tensor import DTensor
    a = a.full_tensor() if isinstance(a, DTensor) else a
    return a[tuple(slice(0, n) for n in b.shape)]


def compare(run, cfg, plan):
    """{quantity: [error on the mesh, one device's noise floor (its largest
    change under two nudges), the reference's largest value, whether the
    mesh's tensor has the reference's shape (the mesh pads the vocab
    further)]}; ``run(lm)`` gives {quantity: tensor}."""
    want = run(one_device(cfg))
    nudged = [run(one_device(cfg, seed)) for seed in (7, 8)]
    got = run(on_mesh(cfg, plan, one_device(cfg)))
    return {k: [float((whole(got[k], w).double() - w.double()).abs().max()),
                max(float((n[k].double() - w.double()).abs().max()) for n in nudged),
                float(w.double().abs().max()), tuple(got[k].shape) == tuple(w.shape)]
            for k, w in want.items()}


def train_step(cfg, plan, ocfg, tok):
    """``compare`` of one train step on [accum, mb, S] tokens ``tok`` (on
    the mesh through ``shard_batch``, which pads a microbatch that the data
    shards do not divide): the loss, the grad norm,
    every leaf of the optimizer state (the JAX package's stacked tree: m and
    v, or their int8 codes and scales, and the master) and every
    parameter after the step."""
    from repro_torch.models.convert import jax_layout
    from repro_torch.models.layers import place, torch_dtype
    from repro_torch.train import train_step as ts
    from repro_torch.train.data import shard_batch
    from repro_torch.train.tree import items, tree_map, unflatten

    def run(lm):
        if not lm.distributed:
            state = ts.init_train_state(lm, ocfg)
            _, m = ts.make_train_step(lm, ocfg, grad_dtype="float32")(
                state, {"tokens": tok, "labels": tok})
            opt = state["opt"]
        else:
            import torch
            lm.requires_grad_(True)
            specs = ts.train_state_specs(lm, ocfg)["opt"]
            zeros = lambda s: place(torch.zeros(s.shape, dtype=torch_dtype(s.dtype)), plan,
                                    plan.spec(*s.logical))
            opt = {k: tree_map(zeros, specs[k]) for k in ("m", "v", "step")}
            # the master: the parameters stacked, placed as the state
            master_specs = dict(items(specs["master"]))
            masters = {}
            for key, (shape, slots) in jax_layout(lm).items():
                w = torch.zeros(shape)
                for idx, p in slots:
                    w[idx] = p.detach().full_tensor()
                masters[key] = place(w, plan, plan.spec(*master_specs[key].logical))
            opt["master"] = unflatten(masters)
            _, m = ts.make_sharded_train_step(lm, ocfg, grad_dtype="float32")(
                {"params": ts.param_tree(lm), "opt": opt},
                shard_batch({"tokens": tok, "labels": tok}, plan))
        out = {f"{part}:{k}": v for part in ("m", "v", "master") for k, v in items(opt[part])}
        out.update({f"params:{n}": p.detach() for n, p in lm.named_parameters()})
        return {"loss": m["loss"], "grad_norm": m["grad_norm"], **out}
    return compare(run, cfg, plan)
