"""The sharded paths repaired or ported after the sharding slice, held to
one device in four gloo processes on a (2, 2) and a (1, 4) ("data",
"model") mesh (reduced configs, float32):

* the Mamba-2 train step on the mesh (the B/C projections whole, the SSD
  per shard with its whole inputs' gradients summed over the shards, the
  gated norm per shard): loss, grad norm, optimizer state and parameters;
* the int8 optimizer state on DTensor leaves (JAX's ``q8_state``: the codes
  cut as ZeRO-1 cuts the f32 state, the scales over every device when
  their count divides it): codes, scales, master and parameters;
* a microbatch of 3 rows on the (2, 2) mesh, padded to 4 as XLA pads it,
  against the unpadded step on one device;
* the prefill on the (1, 4) mesh, whose replicated kv heads are projected
  one per shard and gathered into the cache that decode reads: logits and
  every cache leaf (bfloat16 and int8 caches);
* the decode step under FSDP on the (1, 4) mesh, whose kv projections
  split their contraction over the model axis;
* the SSD with two B/C groups and the causal conv over a sequence cut on
  the mesh, called directly, with their input gradients.

Tolerances are those of tests/test_torch_cells.py: atol 1e-4 plus three
times one device's own change when every weight moves one float32 rounding
step; values that are not O(1) (m, v, the scales) relative to their
largest entry.  The int8 codes may differ by one step where a value sits
at a rounding boundary (``round(x / scale)`` of x that moved by float32
noise): each code within 1 of one device's.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_gloo import run_workers  # noqa: E402

WORKER = r"""
import dataclasses, json
import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
import _torch_gloo as g
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ssm
from repro_torch.models.layers import place
from repro_torch.sharding.plan import make_plan
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.tree import items

rank = g.init()
OCFG = OptimizerConfig(learning_rate=1e-2, warmup_steps=1, eps=1e-3)


def cfg_of(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **kw)


def tokens(cfg, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, shape))


def prefill(cfg, plan, kv_dtype):
    tok = tokens(cfg, (4, 16), 4)

    def run(lm):
        t = place(tok, plan, plan.spec("batch", None)) if lm.distributed else tok
        with torch.no_grad():
            out = lm(t, mode="prefill", kv_dtype=kv_dtype)
        return {"logits": out["logits"], **dict(items(out["cache"]))}
    return g.compare(run, cfg, plan)


def decode_fsdp(cfg, mesh):
    plan = dataclasses.replace(make_plan(cfg, mesh), fsdp=True)
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1)))
    from repro_torch.models.lm import LM
    start = {k: torch.from_numpy(rng.standard_normal(c.shape, dtype=np.float32)) * 0.3
             for k, c in items(LM(cfg, device="meta").cache_struct(4, 16, "float32"))}

    def run(lm):
        cache = lm.init_cache(4, 16, "float32")
        with torch.no_grad():
            for k, c in items(cache):
                c.copy_(distribute_tensor(start[k], c.device_mesh, c.placements)
                        if lm.distributed else start[k])
            t = place(tok, plan, plan.spec("batch", None)) if lm.distributed else tok
            out, _ = lm.decode(cache, t, 9)
        return {"logits": out, **dict(items(cache))}
    return g.compare(run, cfg, plan)


def ssd_groups(mesh):
    # x [b 2, S 24, H 8, P 4], two groups of 4 heads, N 4, chunk 8: on the
    # mesh x is cut on batch (data) and heads (model)
    rng = np.random.default_rng(6)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    x, B, C = t(2, 24, 8, 4), t(2, 24, 2, 4), t(2, 24, 2, 4)
    dt = torch.nn.functional.softplus(t(2, 24, 8))
    A = -torch.exp(t(8) * 0.3)

    heads, whole = (Shard(0), Shard(2)), (Shard(0), Replicate())

    def run(mesh_inputs):
        args = [distribute_tensor(a, mesh, pl) if mesh_inputs else a.clone()
                for a, pl in zip((x, dt, B, C), (heads, heads, whole, whole))]
        for a in args:
            a.requires_grad_(True)
        y, h = ssm.ssd_chunked(args[0], args[1], A, args[2], args[3], chunk=8)
        (y.float().square().sum() + h.float().sum()).backward()
        full = lambda a: a.full_tensor() if hasattr(a, "full_tensor") else a
        return {"y": full(y), "h": full(h), **{f"grad_{n}": full(a.grad) for n, a in
                                               zip(("x", "dt", "B", "C"), args)}}
    want, got = run(False), run(True)
    return {k: [float((got[k] - w).abs().max()), float(w.abs().max())] for k, w in want.items()}


def conv_cut(mesh):
    # x [2, 16, 8] cut on batch (data) and sequence (model), width 4
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 16, 8), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 8), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((8,), dtype=np.float32))

    def run(mesh_inputs):
        a = distribute_tensor(x, mesh, (Shard(0), Shard(1))) if mesh_inputs else x.clone()
        a.requires_grad_(True)
        out = ssm.causal_conv(a, w, b)
        out.square().sum().backward()
        if mesh_inputs:
            return {"out": out.full_tensor(), "grad_x": a.grad.full_tensor()}
        return {"out": out, "grad_x": a.grad}
    want, got = run(False), run(True)
    return {k: [float((got[k] - w_).abs().max()), float(w_.abs().max())]
            for k, w_ in want.items()}


try:
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        res = out["x".join(map(str, shape))] = {}
        m2 = cfg_of("mamba2-1.3b")
        res["mamba2_train"] = g.train_step(m2, make_plan(m2, mesh), OCFG, tokens(m2, (2, 4, 16), 2))
        il = cfg_of("internlm2-1.8b")
        plan = make_plan(il, mesh)
        res["q8_train"] = g.train_step(il, plan, dataclasses.replace(OCFG, state_bits=8),
                                       tokens(il, (2, 4, 16), 2))
        if shape == (2, 2):
            res["padded_train"] = g.train_step(il, plan, OCFG, tokens(il, (2, 3, 16), 3))
        res["prefill"] = prefill(il, plan, "float32")
        res["prefill_int8"] = prefill(il, plan, "int8")
        if shape == (1, 4):         # 2 kv heads over 4 model shards: replicated
            res["decode_fsdp"] = decode_fsdp(il, mesh)
        res["ssd_groups"] = ssd_groups(mesh)
        res["conv_cut"] = conv_cut(mesh)
    if rank == 0:
        print(json.dumps(out))
finally:
    torch.distributed.destroy_process_group()
"""

MESHES = ["2x2", "1x4"]
ATOL = 1e-4
FLOOR_CEILING = 2.5e-3        # test_torch_lm_families.py's cap on the noise floor


@pytest.fixture(scope="module")
def gloo():
    return run_workers(WORKER)


def _held(res, key, base=ATOL, relative=False):
    err, floor, big = res[key][:3]
    scale = big if relative else 1.0
    assert floor < FLOOR_CEILING * scale, (key, floor, big)
    assert big > 0 and err <= base * scale + 3 * floor, (key, err, floor, big)


def _train_held(t, parts_want):
    for key in ("loss", "grad_norm"):
        _held(t, key, base=1e-5, relative=True)
    parts = {}
    for key in t:
        if ":" not in key:
            continue
        part = key.split(":")[0]
        parts[part] = parts.get(part, 0) + 1
        if key.endswith("/q"):       # int8 codes: within one step of one device's
            assert t[key][0] <= 1, (key, t[key])
        elif key.endswith("lm_head/scale") and not t[key][3]:
            # the head's vocab columns padded further on the mesh (1x4): its
            # blocks of 256 cover other elements than one device's (the
            # embedding's padded rows come last: its first blocks are held)
            continue
        else:
            _held(t, key, relative=part in ("m", "v"))
    assert parts == parts_want, parts


@pytest.mark.parametrize("mesh", MESHES)
def test_mamba2_train_step_on_mesh_matches_one_device(gloo, mesh):
    """4 Mamba-2 layers of 17 leaves (the norm and 16 of the mixer),
    stacked in the state; the tied embedding and the final norm."""
    _train_held(gloo[mesh]["mamba2_train"],
                {"m": 17 + 2, "v": 17 + 2, "master": 17 + 2, "params": 4 * 17 + 2})


@pytest.mark.parametrize("mesh", MESHES)
def test_int8_state_on_mesh_matches_one_device(gloo, mesh):
    """m and v as int8 codes and fp32 scales per stacked leaf (12 leaves,
    2 tensors each), the master and the parameters."""
    _train_held(gloo[mesh]["q8_train"],
                {"m": 2 * 12, "v": 2 * 12, "master": 12, "params": 4 * 9 + 3})


def test_padded_microbatch_on_mesh(gloo):
    """3 rows over 2 data shards: padded to 4 on the mesh, the padding row
    masked out of the loss; loss, grad norm, state and parameters equal the
    one-device step on the 3 rows."""
    _train_held(gloo["2x2"]["padded_train"],
                {"m": 12, "v": 12, "master": 12, "params": 4 * 9 + 3})


@pytest.mark.parametrize("kv", ["prefill", "prefill_int8"])
@pytest.mark.parametrize("mesh", MESHES)
def test_prefill_cache_on_mesh_matches_one_device(gloo, mesh, kv):
    """The prefill's logits and the cache it emits (k, v; with int8 also
    their scales), placed as decode reads them."""
    res = gloo[mesh][kv]
    assert set(res) == ({"logits", "k", "v"} | ({"k_scale", "v_scale"} if kv == "prefill_int8"
                                                 else set()))
    for key in res:
        if kv == "prefill_int8" and key in ("k", "v"):
            assert res[key][0] <= 1, (key, res[key])
        else:
            _held(res, key, relative=key.endswith("scale"))


def test_fsdp_decode_on_mesh_matches_one_device(gloo):
    """One decode step under FSDP on the (1, 4) mesh, where the 2 kv heads
    stay replicated over 4 model shards and the kv projections split their
    contraction over the model axis: the logits and the cache after the
    step."""
    res = gloo["1x4"]["decode_fsdp"]
    assert set(res) == {"logits", "k", "v"}
    for key in res:
        _held(res, key)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["ssd_groups", "conv_cut"])
def test_ssd_groups_and_cut_conv_on_mesh(gloo, mesh, case):
    """y, the final state and the input gradients of the SSD with two B/C
    groups, and the causal conv's output and input gradient, each within
    1e-4 of its largest value."""
    for key, (err, big) in gloo[mesh][case].items():
        assert big > 0 and err <= 1e-4 * max(big, 1.0), (key, err, big)
