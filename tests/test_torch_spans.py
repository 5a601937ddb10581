"""The port's spans (``core.scope.named_scope``) on the reduced internlm2
and mamba2 configs, on the CPU.

* Off the profiler nothing is recorded; a profiled decode step is one root
  ``decode`` span (noting that it ran eagerly, off the card) with a
  ``layer`` child per layer and the spans of each layer's parts under
  those, parent ids included.
* A span lies within 50 us of its own ``record_function`` event: the two
  share a clock.
* ``cast_bytes`` is the shape arithmetic of the cache's float32 casts.
* The benchmark's two readers of spans, on hand-built spans and on none.
* ``analysis.account``'s tags and sums with the spans open around them, and
  a backward run inside a span that is not a traffic tag.
* ``serve_batch`` and ``--trace``.
"""
import importlib.util
import json
import statistics
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.analysis.account import TRAFFIC_TAGS, account  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import scope  # noqa: E402
from repro_torch.core.scope import Span, named_scope  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

METRICS = Path(__file__).resolve().parents[1] / "cardbench" / "metrics"
B, S, GEN = 2, 12, 4
ARCHS = ["internlm2-1.8b", "mamba2-1.3b"]
# each span's children in a decode step
TREE = {
    "internlm2-1.8b": {"decode": ["embed", "layer", "head"], "layer": ["attention", "ffn"],
                       "attention": ["cache_write", "attention_core"]},
    "mamba2-1.3b": {"decode": ["embed", "layer", "head"], "layer": ["mamba", "cache_write"],
                    "mamba": ["conv", "ssd_step"]},
}


@pytest.fixture(autouse=True)
def fresh_spans():
    scope.clear()
    yield
    scope.clear()


def _model(arch):
    lm = LM(get_config(arch).reduced(), device="cpu", seed=0)
    prompts = torch.randint(0, lm.cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = lm.forward(prompts, mode="prefill")
    cache = serve.grow_cache(lm.cfg, out["cache"], S + GEN)
    return lm, cache, torch.argmax(out["logits"][:, -1], -1)[:, None]


def _profiled_steps(lm, cache, tok, n):
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(n):
            logits, cache = lm.decode(cache, tok, S + i)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
    return prof.profiler.kineto_results.events()


def _children(spans, parent):
    return [s for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == parent.id]


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("arch", ARCHS)
def test_nothing_is_recorded_off_the_profiler(arch):
    lm, cache, tok = _model(arch)
    with torch.inference_mode():
        lm.decode(cache, tok, S)
    assert scope.spans() == [] and scope.current_scopes() == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_a_decode_step_is_one_tree_of_spans(arch):
    lm, cache, tok = _model(arch)
    _profiled_steps(lm, cache, tok, 1)
    spans = scope.spans()
    roots = [s for s in spans if s.parent == 0]
    assert [(s.tag, s.attrs) for s in roots] == [("decode", {
        "batch": B, "pos": S, "graph": "eager", "why": "not on a CUDA card"})]
    assert len({s.id for s in spans}) == len(spans)
    tree = TREE[arch]
    layers = [s for s in _children(spans, roots[0]) if s.tag == "layer"]
    assert [s.attrs["i"] for s in layers] == list(range(lm.cfg.num_layers))
    assert [s.tag for s in _children(spans, roots[0])] == (
        ["embed"] + ["layer"] * lm.cfg.num_layers + ["head"])
    for layer in layers:
        assert [s.tag for s in _children(spans, layer)] == tree["layer"]
        for part in _children(spans, layer):
            assert [s.tag for s in _children(spans, part)] == tree.get(part.tag, [])
    for s in spans:       # a child lies inside its parent
        if s.parent:
            p = next(q for q in spans if q.id == s.parent)
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert scope.current_scopes() == () and scope.dropped() == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_share_the_profilers_clock(arch):
    """After a warm step each span lies inside its own record_function
    event (5 us of slack for the profiler's clock conversion), and a
    quarter of them within 50 us of their event's edges: the stamps are
    taken just inside the range, so the two clocks differ by less than
    that.  (Many spans sit further in on a busy host, which pauses between
    an edge and the stamp: under six test workers the median read 55 us.)"""
    lm, cache, tok = _model(arch)
    events = _profiled_steps(lm, cache, tok, 3)
    ranges = {}
    for e in events:
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = scope.spans()
    first = min(s.end_ns for s in spans if s.tag == "decode")
    gaps = []
    for tag in {s.tag for s in spans}:
        ss = sorted((s for s in spans if s.tag == tag), key=lambda s: s.start_ns)
        rs = sorted(ranges[tag])
        assert len(rs) == len(ss), tag
        for s, (a, b) in zip(ss, rs):
            if s.start_ns > first:
                assert a - 5_000 <= s.start_ns <= s.end_ns <= b + 5_000, (tag, s, a, b)
                gaps.append(max(s.start_ns - a, b - s.end_ns))
    assert len(gaps) > 20 and statistics.quantiles(gaps, n=4)[0] <= 50_000, sorted(gaps)


def test_cast_bytes_is_the_caches_shape():
    lm, cache, tok = _model("internlm2-1.8b")
    _profiled_steps(lm, cache, tok, 1)
    cfg = lm.cfg
    T = S + GEN                    # the grown cache, read whole
    per_layer = 2 * B * T * cfg.num_kv_heads * cfg.head_dim * (2 + 4)
    casts = [s.attrs["cast_bytes"] for s in scope.spans() if s.tag == "attention_core"]
    assert casts == [per_layer] * cfg.num_layers
    writes = [s.attrs["bytes"] for s in scope.spans() if s.tag == "cache_write"]
    assert writes == [2 * B * cfg.num_kv_heads * cfg.head_dim * 2] * cfg.num_layers


def test_cast_bytes_of_a_quantized_and_a_float32_cache():
    q = torch.zeros(1, 1, 4, 16)
    k8 = torch.zeros(1, 32, 2, 16, dtype=torch.int8)
    with profile(activities=[ProfilerActivity.CPU]):
        attn.attention(q, k8, k8, impl="dot", k_scale=torch.ones(1, 32, 2),
                       v_scale=torch.ones(1, 32, 2), causal=False)
        attn.attention(q, q[:, :, :2], q[:, :, :2], impl="chunked", chunk=4)
    casts = [s.attrs["cast_bytes"] for s in scope.spans() if s.tag == "attention_core"]
    assert casts == [2 * 32 * 2 * 16 * (1 + 4), 0]


def _span(tag, sid, parent, start_ms, end_ms, **attrs):
    return Span(tag, sid, parent, int(start_ms * 1e6), int(end_ms * 1e6), attrs)


def test_the_readers_on_hand_built_spans(monkeypatch):
    gib = 2**30
    hand = [
        _span("attention_core", 2, 1, 0.1, 0.2, cast_bytes=5 * gib),     # in prefill
        _span("prefill", 1, 0, 0.0, 1.0),
        _span("attention_core", 5, 4, 1.2, 1.3, cast_bytes=gib),
        _span("attention", 4, 3, 1.1, 1.4),
        _span("attention_core", 7, 6, 1.5, 1.6, cast_bytes=gib),
        _span("layer", 6, 3, 1.45, 1.7, i=1),
        _span("decode", 3, 0, 1.0, 2.0),                                  # 1 ms, 2 GiB
        _span("attention_core", 9, 8, 2.1, 2.2, cast_bytes=3 * gib),
        _span("decode", 8, 0, 2.0, 5.0),                                  # 3 ms, 3 GiB
        _span("attention_core", 11, 10, 5.1, 5.2, cast_bytes=4 * gib),
        _span("decode", 10, 0, 5.0, 7.0),                                 # 2 ms, 4 GiB
    ]
    host_ms, cast_gib = _reader("decode.host_ms"), _reader("decode.cast_gib")
    monkeypatch.setattr(scope, "spans", lambda: hand)
    assert host_ms(None) == pytest.approx(2.0)
    assert cast_gib(None) == pytest.approx(3.0)
    monkeypatch.setattr(scope, "spans", lambda: [])
    assert host_ms(None) is None and cast_gib(None) is None
    monkeypatch.delattr(scope, "spans")      # a program without spans
    assert host_ms(None) is None and cast_gib(None) is None


def test_attribute_puts_time_launches_and_idle_down_to_the_innermost_span():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, start_ms, dur_ms, user=False):
        return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                               start_ns=lambda: int(start_ms * 1e6),
                               duration_ns=lambda: int(dur_ms * 1e6),
                               is_user_annotation=lambda: user)
    spans = [_span("layer", 2, 1, 1.0, 3.0, bytes=2**29), _span("decode", 1, 0, 0.0, 4.0)]
    events = [ev("cudaLaunchKernel", cpu, 0.5, 0.01), ev("cuLaunchKernel", cpu, 1.5, 0.01),
              ev("cudaLaunchKernelExC", cpu, 2.5, 0.01), ev("cudaMemcpyAsync", cpu, 2.6, 0.1),
              ev("gemm", cuda, 0.5, 1.0), ev("decode", cuda, 0.0, 4.0, user=True),
              ev("tail", cuda, 3.5, 1.0)]
    rows = scope.attribute(spans, events)
    assert rows["decode"] == pytest.approx(
        {"count": 1, "host_ms": 4.0, "self_ms": 2.0, "launches": 1, "idle_ms": 1.0, "gib": 0.0})
    assert rows["layer"] == pytest.approx(
        {"count": 1, "host_ms": 2.0, "self_ms": 2.0, "launches": 2, "idle_ms": 1.5, "gib": 0.5})
    assert set(rows) == {"decode", "layer"}
    assert scope.subtree(spans, "layer") == spans[:1]


def test_account_reads_the_same_tags_and_sums_inside_spans():
    q = torch.randn(2, 1, 4, 16)
    k = torch.randn(2, 24, 2, 16).to(torch.bfloat16)

    def core():
        return attn.attention(q, k, k, impl="dot", causal=False)

    def spanned():
        with named_scope("decode", pos=3), named_scope("layer", i=0), \
                named_scope("attention"):
            return core()
    _, bare = account(core)
    _, inside = account(spanned)
    with profile(activities=[ProfilerActivity.CPU]):
        _, recorded = account(spanned)
    assert bare.traffic_by_tag and set(bare.traffic_by_tag) <= set(TRAFFIC_TAGS)
    for acct in (inside, recorded):
        assert acct.traffic_by_tag == bare.traffic_by_tag
        assert (acct.flops, acct.traffic_bytes) == (bare.flops, bare.traffic_bytes)


def test_account_tags_a_decode_step_by_its_traffic_tags_alone():
    lm, cache, tok = _model("internlm2-1.8b")
    with torch.inference_mode():
        _, acct = account(lambda: lm.decode(cache, tok, S))
    assert set(acct.traffic_by_tag) == {"attention_core"}


def test_a_backward_inside_a_span_keeps_the_forwards_tags():
    """A span that is not a traffic tag ("train_step") open around the
    backward: the backward's ops still take their forward's tags."""
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 4, requires_grad=True)

    def step():
        with named_scope("train_step"):
            with named_scope("attention_core"):
                y = a @ b
            y.backward(torch.ones(8, 4))

    _, acct = account(step)
    f = 4
    forward = (8 * 16 + 16 * 4 + 8 * 4) * f
    backward = (8 * 4 + 4 * 16 + 8 * 16) * f + (16 * 8 + 8 * 4 + 16 * 4) * f
    assert acct.traffic_by_tag == {"attention_core": forward + backward}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_is_the_greedy_loop(arch):
    lm, _, _ = _model(arch)
    prompts = torch.randint(0, lm.cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(3))
    seen = []
    toks, logits, t_prefill, t_decode = serve.serve_batch(
        lm, prompts, GEN, on_token=lambda i, t: seen.append((i, t.device.type, tuple(t.shape))))
    assert seen == [(i, "cpu", (B, 1)) for i in range(GEN)]
    assert toks.shape == (B, GEN) and t_prefill > 0 and t_decode > 0
    with torch.inference_mode():
        out = lm.forward(prompts, mode="prefill")
        cache = serve.grow_cache(lm.cfg, out["cache"], S + GEN)
        tok = torch.argmax(out["logits"][:, -1], -1)[:, None]
        want = [tok]
        for i in range(GEN - 1):
            step, cache = lm.decode(cache, tok, S + i)
            tok = torch.argmax(step[:, -1], -1)[:, None]
            want.append(tok)
    assert torch.equal(logits, out["logits"])
    assert (toks == torch.cat(want, 1).numpy()).all()


def test_serve_trace_writes_the_export_and_prints_the_spans(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"]
    plain = serve.run(argv)
    path = tmp_path / "serve.json"
    traced = serve.run(argv + ["--trace", str(path)])
    assert (plain.tokens == traced.tokens).all()
    out = capsys.readouterr().out
    assert "spans, the batch" in out and "spans, one decode step (mean of 2)" in out
    assert "[serve] decode steps by how they ran: capture 0, replay 0, eager " in out
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {"serve.batch", "prefill", "decode", "sample", "grow_cache"} <= names
    spans = [json.loads(line) for line in (tmp_path / "serve.json.spans.jsonl").open()]
    assert [s["tag"] for s in spans if s["parent"] == 0] == ["serve.batch"]
    assert next(s for s in spans if s["tag"] == "grow_cache")["attrs"]["bytes"] > 0
