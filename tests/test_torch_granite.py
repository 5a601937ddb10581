"""granite-4.0-h-small on the port, at a tiny size on the CPU (one period of
10 layers, hidden 128, 8 experts of which 4 are held, top-2, a shared
expert), against the benchmark's plain reference (``cardbench/reference/
hybrid.py``) on weights drawn from a seed:

* the registered config, the defaults of its new fields (every other
  config is as it was) and ``reduced()`` keeping one whole period;
* the program's prefill logits, every decode step through the hybrid
  cache and the train forward against the reference's full forward, in
  float32 (the same equations: to float32 rounding) and in bfloat16;
* the shares of experts 0-3 and 4-7, the shared expert counted once, add
  up to the uncut reference's whole layer, on both dispatch layouts;
* a router that sends every token to one expert drops nothing, and
  ``dropped`` reads a pair the slot layout cannot take;
* the ``moe`` span tree and its counters.
"""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cardbench import families, port, weights  # noqa: E402
from cardbench.reference import hybrid as ref  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs.all_configs import ARCH_IDS  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import scope  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ARCH = "granite-4.0-h-small"
B, S, GEN = 2, 40, 6
TINY = dict(name="tiny-granite", num_hidden_layers=10, hidden_size=128,
            num_attention_heads=4, num_key_value_heads=2, head_dim=32, mamba_d_state=16,
            mamba_d_head=16, mamba_chunk_size=16, intermediate_size=64,
            shared_intermediate_size=96, experts_published=8, num_local_experts=4,
            num_experts_per_tok=2, vocab_size=300)
# the two dispatch layouts of the held path in prefill, by SLOT_TOKENS
LAYOUTS = {"sorted": 64, "slots": 10**6}


def tiny(**kw):
    cfg = json.loads((REPO / "cardbench" / "configs" / f"{ARCH}.json").read_text())
    cfg.update(TINY, layer_types=cfg["layer_types"][:10], **kw)
    return families.at_root(cfg, REPO)


def build(cfg, dtype):
    """The program with weights drawn from a seed (bf16), in ``dtype``."""
    w = weights.draw(cfg, 7, "cpu")
    if dtype == torch.bfloat16:
        return port.build(cfg, w), w
    w = {k: v.to(dtype) for k, v in w.items()}
    lm = LM(port.model_config(dict(cfg, torch_dtype="float32")), device="meta")
    lm.load_state_dict(weights.port_state(cfg, w), assign=True)
    return lm, w


def serve_logits(lm, prompts, kv_dtype):
    """Prefill, grow the cache, greedy decode: the logits of every step
    [B, GEN, V_pad] and the tokens served."""
    with torch.inference_mode():
        out = lm.forward(prompts, mode="prefill", kv_dtype=kv_dtype)
        cache = serve.grow_cache(lm.cfg, out["cache"], S + GEN)
        logits = [out["logits"][:, -1].float()]
        toks = [logits[-1].argmax(-1)[:, None]]
        for i in range(GEN - 1):
            step, cache = lm.decode(cache, toks[-1], S + i)
            logits.append(step[:, -1].float())
            toks.append(logits[-1].argmax(-1)[:, None])
    return torch.stack(logits, 1), torch.cat(toks, 1)


def prompts_of(cfg):
    return torch.randint(0, cfg["vocab_size"], (B, S), generator=torch.Generator().manual_seed(3))


@pytest.fixture
def layout(request, monkeypatch):
    monkeypatch.setattr(moe_mod, "SLOT_TOKENS", LAYOUTS[request.param])
    return request.param


# ----------------------------------------------------------------- configs
def test_the_registered_config():
    cfg = get_config(ARCH)
    assert ARCH not in ARCH_IDS
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.vocab_size) == ("hybrid", 40, 4096, 100352)
    assert [i for i in range(40) if cfg.is_attn_layer(i)] == [5, 15, 25, 35]
    assert all(cfg.is_moe_layer(i) for i in range(40))
    m = cfg.moe
    assert (m.num_experts, m.top_k, m.d_ff_expert, m.d_ff_shared) == (72, 10, 768, 1536)
    assert (m.held, m.held_range) == (72, (0, 72))
    s = cfg.ssm
    assert (s.d_state, s.head_dim, s.n_heads(cfg.d_model), s.n_groups, s.conv_width,
            s.chunk_size) == (128, 64, 128, 1, 4, 256)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 8, 128)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier, cfg.logits_scaling,
            cfg.attention_multiplier, cfg.rope) == (12.0, 0.22, 16.0, 1 / 128, False)


def test_the_cut_holds_18_6_billion_parameters():
    """36 of the 72 experts held, all else as published: 18.6 B parameters
    (the whole model 32.2 B)."""
    full = get_config(ARCH)
    cut = dataclasses.replace(full, moe=dataclasses.replace(full.moe, held=36))
    n = {c.moe.held: sum(p.numel() for p in LM(c, device="meta").parameters())
         for c in (full, cut)}
    assert round(n[36] / 1e9, 1) == 18.6 and round(n[72] / 1e9, 1) == 32.2


@pytest.mark.parametrize("arch", [a for a in list_configs() if a != ARCH])
def test_the_new_fields_leave_every_other_config_alone(arch):
    cfg = get_config(arch)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier, cfg.logits_scaling,
            cfg.attention_multiplier, cfg.rope) == (None, 1.0, 1.0, None, True)
    assert "multiplier" not in repr(cfg) and "rope=" not in repr(cfg)
    if cfg.moe is not None:
        m = cfg.moe
        assert (m.d_ff_shared, m.held, m.first_held) == (0, 0, 0)
        assert m.held_range == (0, m.num_experts)


@pytest.mark.parametrize("arch,layers", [(ARCH, 10), ("jamba-1.5-large-398b", 8)])
def test_reduced_keeps_one_whole_period(arch, layers):
    r = get_config(arch).reduced()
    assert r.num_layers == layers == r.hybrid.attn_period
    assert LM(r, device="meta").n_groups == 1


def test_reduced_scales_the_held_share():
    full = get_config(ARCH)
    r = dataclasses.replace(full, moe=dataclasses.replace(full.moe, held=36)).reduced()
    assert (r.moe.num_experts, r.moe.held, r.moe.top_k, r.moe.d_ff_shared) == (8, 4, 2, 128)


# --------------------------------------------------- against the reference
@pytest.mark.parametrize("layout", sorted(LAYOUTS), indirect=True)
@pytest.mark.parametrize("held", [4, 8])
@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_float32_program_is_the_reference(layout, held, impl):
    """In float32 the program and the reference compute one function: the
    prefill, every decode step through the cache and the train forward
    agree to float32 rounding (1e-5 of the largest logit)."""
    cfg = tiny(num_local_experts=held, attention_impl=impl)
    lm, w = build(cfg, torch.float32)
    prompts = prompts_of(cfg)
    got, toks = serve_logits(lm, prompts, "float32")
    with torch.inference_mode():
        train = lm.forward(prompts, mode="train")["logits"]
    V = cfg["vocab_size"]
    for b in range(B):
        seq = torch.cat([prompts[b], toks[b, :-1]])
        want = ref.logits(w, cfg, seq, torch.arange(S - 1, S + GEN - 1))
        assert (got[b, :, :V] - want).abs().max() < 1e-5 * want.abs().max()
        want = ref.logits(w, cfg, prompts[b], torch.arange(S))
        assert (train[b, :, :V] - want).abs().max() < 1e-5 * want.abs().max()


@pytest.mark.parametrize("top_k,tol", [(8, 5e-2), (2, 5e-2)])
def test_bfloat16_program_against_the_reference(top_k, tol):
    """In bfloat16 through ten layers the logits move by ~3% of the largest
    (``tol`` 5%).  With every expert chosen (top 8 of 8) no routing can
    change, so every position is held to it, and the float8 control departs
    further than the program; at top 2 a router that picks another expert
    where two logits lie within a bf16 rounding moves that position more,
    so the median position is held to it."""
    cfg = tiny(num_experts_per_tok=top_k)
    lm, w = build(cfg, torch.bfloat16)
    prompts = prompts_of(cfg)
    got, toks = serve_logits(lm, prompts, "bfloat16")
    V = cfg["vocab_size"]
    for b in range(B):
        seq = torch.cat([prompts[b], toks[b, :-1]])
        pos = torch.arange(S - 1, S + GEN - 1)
        want = ref.logits(w, cfg, seq, pos)
        err = (got[b, :, :V] - want).abs().max(dim=-1).values
        scale = want.abs().max()
        if top_k == 8:
            assert err.max() < tol * scale, (err, scale)
            ctrl = ref.logits(w, cfg, seq, pos, fp8=True)
            assert (ctrl - want).abs().max() > err.max()
        else:
            assert err.median() < tol * scale, (err, scale)


# --------------------------------------------------------- the MoE layer
def moe_layer(T, D=32, E=8, F=16, Fs=24, top_k=2, seed=0):
    """A layer's weights (float32, as ``weights.draw`` names them, one
    layer stacked) and tokens [1, T, D]."""
    g = torch.Generator().manual_seed(seed)
    w = {"layers.moe_router": torch.randn(1, D, E, generator=g) * D ** -0.5,
         "layers.moe_w_gate": torch.randn(1, E, D, F, generator=g) * D ** -0.5,
         "layers.moe_w_up": torch.randn(1, E, D, F, generator=g) * D ** -0.5,
         "layers.moe_w_down": torch.randn(1, E, F, D, generator=g) * F ** -0.5,
         "layers.moe_w_shared_gate": torch.randn(1, D, Fs, generator=g) * D ** -0.5,
         "layers.moe_w_shared_up": torch.randn(1, D, Fs, generator=g) * D ** -0.5,
         "layers.moe_w_shared_down": torch.randn(1, Fs, D, generator=g) * Fs ** -0.5}
    cfg = {"num_experts_per_tok": top_k, "num_local_experts": E}
    return w, cfg, torch.randn(1, T, D, generator=g)


def share(w, x, lo, hi, shared, top_k=2):
    """The program's MoE FFN holding experts [lo, hi), with or without the
    shared expert."""
    E = w["layers.moe_router"].shape[-1]
    p = {"router": w["layers.moe_router"][0]}
    for name in ("w_gate", "w_up", "w_down"):
        p[name] = w[f"layers.moe_{name}"][0, lo:hi]
    if shared:
        for name in ("w_shared_gate", "w_shared_up", "w_shared_down"):
            p[name] = w[f"layers.moe_{name}"][0]
    moe = MoEConfig(num_experts=E, top_k=top_k, d_ff_expert=p["w_gate"].shape[-1],
                    held=hi - lo, first_held=lo)
    return moe_mod.moe_ffn(x, p, moe)[0]


@pytest.mark.parametrize("T", [12, 200])       # the slot layout, the sorted one
def test_the_expert_shares_add_up_to_the_whole_layer(T):
    """Experts 0-3 with the shared expert plus experts 4-7 without it give
    what the uncut reference gives for the whole layer."""
    w, cfg, x = moe_layer(T)
    whole = ref._moe(x[0], w, 0, cfg, False)
    parts = share(w, x, 0, 4, True) + share(w, x, 4, 8, False)
    assert (parts[0] - whole).abs().max() < 1e-5 * whole.abs().max()
    # and each share is the reference's own share of it
    half = ref._moe(x[0], w, 0, dict(cfg, num_local_experts=4), False)
    assert (share(w, x, 0, 4, True)[0] - half).abs().max() < 1e-5 * half.abs().max()


@pytest.mark.parametrize("T", [12, 200])
def test_a_skewed_router_drops_nothing(T):
    """A router that sends every token to expert 0: the held path computes
    all T of its pairs and matches the reference, where the capacity of the
    index path (1.25 x T x 2 / 8) drops most of them."""
    w, cfg, x = moe_layer(T)
    x[..., 0] = 8.0
    w["layers.moe_router"][0, 0, 0] = 4.0
    top = torch.topk(x[0] @ w["layers.moe_router"][0], 2, dim=-1).indices
    assert (top == 0).any(dim=-1).all()
    whole = ref._moe(x[0], w, 0, cfg, False)
    scope.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = share(w, x, 0, 8, True)
    (sp,) = [s for s in scope.spans() if s.tag == "moe"]
    scope.clear()
    assert sp.attrs["pairs"] == 2 * T and sp.attrs["dropped"] == 0
    assert (got[0] - whole).abs().max() < 1e-5 * whole.abs().max()
    p = {k[len("layers.moe_"):]: v[0] for k, v in w.items() if "shared" not in k}
    capped = moe_mod.moe_ffn_index(x, p, MoEConfig(num_experts=8, top_k=2, d_ff_expert=16))[0]
    routed = whole - ref._swiglu(x[0], w["layers.moe_w_shared_gate"][0],
                                 w["layers.moe_w_shared_up"][0],
                                 w["layers.moe_w_shared_down"][0], False)
    assert (capped[0] - routed).abs().max() > 0.1 * routed.abs().max()


@pytest.mark.parametrize("T", [12, 200])       # the slot layout, the sorted one
def test_dropped_reads_a_pair_the_experts_did_not_take(T, monkeypatch):
    """A router that names one expert twice for token 0 (top-k never
    does): the slot layout has one slot for the two pairs and weighs one,
    and ``dropped`` reads the other; the sorted layout gives each pair its
    own row and drops none."""
    w, cfg, x = moe_layer(T)
    topk_gates = moe_mod._topk_gates

    def twice(probs, k, norm_topk=True):
        gates, eidx = topk_gates(probs, k, norm_topk)
        eidx = eidx.clone()
        eidx[0, 1] = eidx[0, 0]
        return gates, eidx

    monkeypatch.setattr(moe_mod, "_topk_gates", twice)
    scope.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        share(w, x, 0, 8, True)
    (sp,) = [s for s in scope.spans() if s.tag == "moe"]
    scope.clear()
    lost = 1 if T <= moe_mod.SLOT_TOKENS else 0
    assert (sp.attrs["pairs"], sp.attrs["dropped"]) == (2 * T - lost, lost)


# ------------------------------------------------------------------ spans
@pytest.mark.parametrize("T", [12, 200])
def test_the_moe_span_and_its_counters(T):
    """One ``moe`` span: router, dispatch, experts and combine (in the
    sorted layout the sort, then each expert's gather, products and add,
    then the sum's cast), then shared; ``held``, the ``pairs`` the router
    sent to the held experts, ``dropped`` 0 and ``copy_bytes``."""
    w, cfg, x = moe_layer(T)
    scope.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        share(w, x, 0, 4, True)
    spans = scope.spans()
    scope.clear()
    (sp,) = [s for s in spans if s.tag == "moe"]
    kids = [s.tag for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == sp.id]
    top = torch.topk(x[0] @ w["layers.moe_router"][0], 2, dim=-1).indices
    if T <= moe_mod.SLOT_TOKENS:
        assert kids == ["router", "dispatch", "experts", "combine", "shared"]
    else:
        busy = len(set(top[top < 4].tolist()))           # held experts with a pair
        assert kids == (["router", "dispatch"] + ["dispatch", "experts", "combine"] * busy
                        + ["combine", "shared"])
    pairs = int((top < 4).sum())
    D = x.shape[-1]
    copy = (4 * T * D * 4 + T * D * 8 if T <= moe_mod.SLOT_TOKENS
            else pairs * D * 12 + T * D * 4)
    assert sp.attrs == {"held": 4, "pairs": pairs, "dropped": 0, "copy_bytes": copy}


def test_a_decode_step_has_a_moe_span_in_every_layer():
    cfg = tiny()
    lm, _ = build(cfg, torch.bfloat16)
    prompts = prompts_of(cfg)
    with torch.inference_mode():
        out = lm.forward(prompts, mode="prefill")
        cache = serve.grow_cache(lm.cfg, out["cache"], S + 1)
        scope.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            lm.decode(cache, out["logits"][:, -1].argmax(-1)[:, None], S)
    spans = scope.spans()
    scope.clear()
    moes = [s for s in spans if s.tag == "moe"]
    assert len(moes) == 10
    by_id = {s.id: s for s in spans}
    assert all(by_id[s.parent].tag == "ffn" for s in moes)
    assert all(s.attrs["held"] == 4 and s.attrs["dropped"] == 0
               and 0 <= s.attrs["pairs"] <= B * 2 for s in moes)


def test_serve_runs_it_reduced():
    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len", "20",
                       "--gen", "3", "--batch", "2"])
    assert toks.shape == (2, 3)
