"""The hybrid family (granite-4.0-h-small) in the benchmark, on the CPU: its
weights map one to one onto the program's parameters at full size, its
yardstick counts agree with a hand count, its two metric readers read a
planted span tree, and a tiny hybrid cell runs correct and fails under its
state fault."""
import json

import pytest

from cardbench import families, harness, port, weights, yardstick
from cardbench.faults import FAULTS
from cardbench.tests.tiny import BENCH, LIMIT, REPO, make_root

NAME = "granite-4.0-h-small"
SEED = 2**31 + 77
TINY = dict(name="tiny-hybrid", num_hidden_layers=10, hidden_size=128,
            num_attention_heads=4, num_key_value_heads=2, head_dim=32, mamba_d_state=16,
            mamba_d_head=16, mamba_chunk_size=16, intermediate_size=64,
            shared_intermediate_size=96, experts_published=8, num_local_experts=4,
            num_experts_per_tok=2, vocab_size=300)
CELL = "tiny-hybrid.tinymix"
# the logits are divided by logits_scaling (16), and so is the tiny cells'
# limit: the program reads gaps of 0 to ~1e-3 here, its faults 0.02-0.03
TINY_LIMIT = LIMIT / 16


def config(**kw):
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    cfg.update(kw)
    if "num_hidden_layers" in kw:
        cfg["layer_types"] = cfg["layer_types"][:kw["num_hidden_layers"]]
    return families.at_root(cfg, REPO)


@pytest.fixture
def root(tmp_path):
    """The tiny checkout of ``tiny.make_root`` with a hybrid cell beside its
    own."""
    root = make_root(tmp_path)
    bench = root / BENCH.name
    cfg = config(**TINY)
    del cfg[families.ROOT_KEY]
    (bench / "configs" / "tiny-hybrid.json").write_text(json.dumps(cfg))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps({"max_gap": {"limit": TINY_LIMIT}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-hybrid", "source": "tiny", "reduced": [], "why": "test",
                            "file": f"{BENCH.name}/configs/tiny-hybrid.json"})
    spec["workloads"].append({"name": CELL, "config": "tiny-hybrid", "traffic": "tinymix",
                              "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_every_name_maps_one_to_one_onto_the_programs_parameters():
    """At full size (the program on the meta device): each slice of each
    stacked tensor is one parameter of the program, of its shape, and every
    parameter is one slice."""
    from repro_torch.models.lm import LM
    cfg = config()
    fam = families.module(cfg)
    mapped = {}
    for name, (shape, _, _) in weights.specs(cfg).items():
        if not name.startswith("layers."):
            mapped[name] = tuple(shape)
            continue
        for i in range(shape[0]):
            key = fam.param_name(cfg, name[len("layers."):], i)
            assert key not in mapped
            mapped[key] = tuple(shape[1:])
    want = {k: tuple(t.shape) for k, t in LM(port.model_config(cfg), device="meta")
            .state_dict().items()}
    assert mapped == want
    assert sum(t.numel() for t in LM(port.model_config(cfg), device="meta").parameters()) \
        == pytest.approx(18.6e9, rel=3e-3)


def test_the_program_gets_the_configs_sizes():
    m = port.model_config(config())
    assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads, m.head_dim) == \
        (40, 4096, 32, 8, 128)
    assert (m.moe.num_experts, m.moe.held_range, m.moe.top_k, m.moe.d_ff_expert,
            m.moe.d_ff_shared) == (72, (0, 36), 10, 768, 1536)
    assert (m.ssm.d_state, m.ssm.head_dim, m.ssm.n_heads(4096), m.ssm.chunk_size) == \
        (128, 64, 128, 256)
    assert (m.embedding_multiplier, m.residual_multiplier, m.logits_scaling,
            m.attention_multiplier, m.rope, m.norm_eps) == (12, 0.22, 16, 0.0078125, False, 1e-5)


def test_the_yardstick_counts_by_hand():
    """The tiny config: 9 Mamba-2 layers (inner 256, 16 heads of 16, state
    16), 1 attention layer (4 q / 2 kv heads of 32), 10 MoE FFNs (router 8
    wide, 2 of 8 chosen, 4 of 8 held, experts 64 wide, shared 96)."""
    cfg = config(**TINY)
    fam = families.module(cfg)
    D = 128
    mamba = D * (2 * 256 + 2 * 16 + 16) + 256 * D
    attn = D * 4 * 32 * 2 + D * 2 * 32 * 2
    moe = D * 8 + 3 * D * 96 + 1 * 3 * D * 64         # 2 x 4 / 8 = 1 routed expert a token
    assert fam.projection_params(cfg) == 9 * mamba + attn + 10 * moe
    S, Q = 40, 16
    nc = 3                                               # chunks of 16 over 40
    ssd = (2 * Q * Q * 16 * 1 * nc + 2 * (Q * (Q + 1) // 2) * 16 * 16 * nc
           + 2 * Q * 16 * 16 * 16 * nc + 2 * 16 * 16 * Q * 16 * nc)
    att = 4 * 32 * (S * (S + 1) // 2) * 4
    assert fam.mixer_flops(cfg, S) == 9 * ssd + att
    assert yardstick.prefill_flops(cfg, 2, S) == 2 * (
        2 * (9 * mamba + attn + 10 * moe) * S + 2 * D * 300 + 9 * ssd + att)


def test_the_prefill_flops_at_full_size():
    """4 x 32k: the MoE (5 held pairs a token, the shared expert and the
    router) is 37% of the FLOPs, Mamba-2 53% and attention 10%."""
    cfg = config()
    assert yardstick.prefill_flops(cfg, 4, 32768) == 1875366398394368.0


def _span(tag, sid, parent, start_ms, end_ms, **attrs):
    from repro_torch.core.scope import Span
    return Span(tag, sid, parent, int(start_ms * 1e6), int(end_ms * 1e6), attrs)


def test_the_moe_readers_on_a_planted_span_tree(monkeypatch):
    from repro_torch.core import scope
    gib = 2**30
    spans = [
        _span("moe", 3, 2, 0.1, 0.3, copy_bytes=2 * gib),     # prefill 1: 2 + 4 GiB
        _span("ffn", 2, 1, 0.1, 0.4),
        _span("moe", 4, 1, 0.5, 0.6, copy_bytes=4 * gib),
        _span("prefill", 1, 0, 0.0, 1.0),
        _span("moe", 6, 5, 1.1, 1.2, copy_bytes=gib),         # prefill 2: 1 GiB
        _span("prefill", 5, 0, 1.0, 2.0),
        _span("moe", 8, 7, 2.1, 2.6),                         # decode 1: 0.5 + 1 ms
        _span("moe", 9, 7, 2.7, 3.7),
        _span("decode", 7, 0, 2.0, 4.0),
        _span("moe", 11, 10, 4.1, 4.3),                       # decode 2: 0.2 ms
        _span("decode", 10, 0, 4.0, 5.0),
        _span("moe", 13, 12, 5.1, 5.5),                       # decode 3: 0.4 ms
        _span("layer", 12, 14, 5.0, 5.6),
        _span("decode", 14, 0, 5.0, 6.0),
        _span("moe", 15, 0, 6.1, 9.0, copy_bytes=gib),        # in neither
    ]
    host_ms = harness.reader(BENCH.parent, "moe.decode_host_ms")
    copy_gib = harness.reader(BENCH.parent, "moe.prefill_copy_gib")
    monkeypatch.setattr(scope, "spans", lambda: spans)
    assert host_ms(None) == pytest.approx(0.4)
    assert copy_gib(None) == pytest.approx(3.5)
    # a program whose steps have no moe span, or that records no spans
    monkeypatch.setattr(scope, "spans", lambda: [s for s in spans if s.tag != "moe"])
    assert host_ms(None) is None and copy_gib(None) is None
    monkeypatch.delattr(scope, "spans")
    assert host_ms(None) is None and copy_gib(None) is None


def test_a_tiny_hybrid_cell_is_correct_and_reports_the_moe_metrics(root):
    r = harness.run_cell(root, CELL, SEED, 0.0, True, device="cpu")
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["moe.decode_host_ms"]["value"] > 0
    assert m["moe.prefill_copy_gib"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(root, fault):
    cfg = harness.load_cell(root, CELL)[1]
    with FAULTS[fault](cfg):
        r = harness.run_cell(root, CELL, SEED, 0.0, False, device="cpu")
    assert not r["correct"]
    assert r["checks"]["max_gap"]["value"] > r["checks"]["max_gap"]["limit"]


def test_the_state_fault_freezes_both_kinds_of_state(root):
    """Under the fault a decode step leaves the Mamba-2 states and the KV
    cache as they were."""
    import torch
    from repro_torch.launch.serve import grow_cache
    cfg = harness.load_cell(root, CELL)[1]
    lm = port.build(cfg, weights.draw(cfg, 5, "cpu"))
    prompts = torch.randint(0, 300, (2, 20), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        cache = grow_cache(lm.cfg, lm.forward(prompts, mode="prefill")["cache"], 22)
        before = {k: v.clone() for k, v in (("k", cache["attn"]["k"]), ("ssm", cache["ssm"]),
                                             ("conv", cache["conv"]))}
        with FAULTS["state_unchanged"](cfg):
            lm.decode(cache, prompts[:, -1:], 20)
        assert torch.equal(before["k"], cache["attn"]["k"])
        assert torch.equal(before["ssm"], cache["ssm"]) and torch.equal(before["conv"],
                                                                        cache["conv"])
        lm.decode(cache, prompts[:, -1:], 20)
        assert not torch.equal(before["k"], cache["attn"]["k"])
        assert not torch.equal(before["ssm"], cache["ssm"])
