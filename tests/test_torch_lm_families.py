"""Port parity for the MoE, hybrid, enc-dec and vlm families of the LM.

``get_config(arch).reduced()`` in both frameworks for phi3.5-moe,
qwen3-moe, jamba-1.5, whisper and llava, the JAX model built on
``single_device_mesh()``.  A JAX parameter tree (JAX's layout and init
rules), token ids, frame embeddings (whisper) and image-prefix embeddings
(llava) are drawn once in NumPy from a seed and fed to both; the port
takes the parameters through ``repro_torch.models.convert``.

* convert carries every weight exactly;
* f32 (params and ``dtype`` cast in both): train logits, loss and aux
  loss, prefill logits and the prefill cache; one decode step from JAX's
  (grown) prefill cache, logits and the new cache.  Each at atol 1e-4 plus
  three times the reference's own float32 noise floor there: how far JAX's
  output moves when every weight moves by one float32 rounding step.  At this init a
  reduced model's logits move by 2e-4 to 3.5e-4 under such a nudge (float64
  runs of the port), and llava's f32 train logits lie 2.0e-3 from a
  float64 evaluation in JAX and 1.1e-3 in the port, so a fixed 1e-4 would
  test rounding luck, not the port.  Every floor must stay under
  ``FLOOR_CEILING`` (the largest here is whisper's caches, 1.8e-3): a nudge
  that flipped a routing choice or a more chaotic init would make a floor,
  and so the tolerance, O(1), and the fixture fails instead;
* bf16 prefill -> decode against forward at rel < 0.08 with
  capacity_factor 16 (tests/test_models_smoke.py:57-95);
* ``repro_torch.launch.serve --reduced --device cpu`` for each family.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.sharding.plan import make_plan as jax_make_plan  # noqa: E402
from repro.sharding.plan import single_device_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import grow_cache  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
         "whisper-medium", "llava-next-34b"]
B, S = 2, 24          # ragged against jamba's reduced SSD chunk of 16
FLOOR_CEILING = 2.5e-3


def _inputs(cfg, seed=0):
    """Token ids, the next token and the family's extra inputs, in NumPy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    kw = {}
    if cfg.encoder is not None:
        kw["enc_embeds"] = (rng.standard_normal((B, cfg.encoder.source_len, cfg.d_model))
                            * 0.02).astype(np.float32)
    if cfg.num_image_tokens:
        kw["embeds_prefix"] = (rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model))
                               * 0.02).astype(np.float32)
    return toks, nxt, kw


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy().copy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in sorted(tree.items()) for x in _leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _f32_cfg(cfg):
    """The config of the f32 comparisons: ``dtype`` float32 too, since the
    JAX encoder casts its frames to ``cfg.dtype`` and its layer scan then
    refuses a bfloat16 carry against float32 weights."""
    return dataclasses.replace(cfg, dtype="float32")


def _nudge(tree, seed):
    """Every weight moved by one float32 rounding step (x (1 +- 2**-24)):
    how far the reference's own f32 outputs move under it is their float32
    noise floor."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a * (1 + np.float32(2.0 ** -24) * rng.choice(
        np.array([-1, 1], np.float32), a.shape)), tree)


def _draw_params(specs, seed=0):
    """A JAX parameter tree drawn in NumPy from a seed: the layout and the
    init rules of ``repro.models.layers.init_param`` for JAX's
    ``param_specs()`` (fan-in normal, zeros, ones, the SSM's dt bias), in
    each spec's dtype.  Drawing it here spares a multi-second compile of
    JAX's init per model; JAX and, through ``convert``, the port both take
    it."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        shape = spec.shape
        if spec.init in ("zeros", "ones"):
            x = np.full(shape, 1.0 if spec.init == "ones" else 0.0, np.float32)
        elif spec.init == "ssm_dt":
            dt = np.exp(np.log(1e-3) + (np.log(1e-1) - np.log(1e-3)) * rng.random(shape))
            x = dt + np.log(-np.expm1(-dt))
        else:
            assert spec.init == "normal", spec.init
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            x = rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))
        return np.asarray(jnp.asarray(x, jnp.float32).astype(spec.dtype))

    def walk(t):
        return {k: walk(v) for k, v in sorted(t.items())} if isinstance(t, dict) else draw(t)

    return walk(specs)


_JAX_FNS = {}


def _jax_fns(cfg, mesh):
    """The JAX LM of ``cfg``, its f32 train and prefill forwards jitted as
    one function (XLA shares their common work, and one compile costs less
    than two) and its jitted decode; shared by configs that differ only in
    name: reduced qwen3-moe and phi3.5-moe are the same model (8 experts,
    top-2, 2 kv heads)."""
    key = dataclasses.replace(cfg, name="", source="")
    if key not in _JAX_FNS:
        lm_j = JaxLM(_f32_cfg(cfg), jax_make_plan(cfg, mesh))

        def forward(p, t, kw):
            train = lm_j.forward(p, t, mode="train", **kw)
            pf = lm_j.forward(p, t, mode="prefill", kv_dtype="float32", **kw)
            return train["logits"], train["aux_loss"], pf

        _JAX_FNS[key] = (lm_j, jax.jit(forward), jax.jit(lm_j.decode))
    return _JAX_FNS[key]


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """The JAX model, its params, the inputs and JAX's f32 outputs: train
    logits and aux loss; prefill logits and cache (f32 KV); one decode step
    from that cache grown by the port's ``grow_cache``.  Each output is also
    computed twice with the weights nudged by ``_nudge``: the largest change
    is that output's float32 noise floor (``floor``)."""
    cfg = jax_get_config(request.param).reduced()
    mesh = single_device_mesh()
    lm_j, forward, decode = _jax_fns(cfg, mesh)
    params = _draw_params(lm_j.param_specs())
    p32 = jax.tree.map(lambda a: a.astype(np.float32), params)
    toks, nxt, kw = _inputs(cfg)
    kw_j = {k: jnp.asarray(v) for k, v in kw.items()}
    n_img = cfg.num_image_tokens

    def run(p):
        with mesh:
            logits, aux, pf = forward(p, jnp.asarray(toks), kw_j)
            pf_cache = jax.tree.map(np.asarray, pf["cache"])
            grown = _numpy(grow_cache(cfg, _torch(pf_cache), 2 * S + n_img))
            logits_d, cache_d = decode(p, jax.tree.map(jnp.asarray, grown),
                                       jnp.asarray(nxt), S + n_img)
        return dict(train_logits=np.asarray(logits), aux=np.asarray(aux),
                    pf_logits=np.asarray(pf["logits"]), pf_cache=pf_cache, grown=grown,
                    decode_logits=np.asarray(logits_d),
                    decode_cache=jax.tree.map(np.asarray, cache_d))

    out = run(p32)
    floor = {k: {} for k in out if k != "grown"}
    for seed in (7, 8):
        nudged = run(_nudge(p32, seed))
        for k, leaves in floor.items():
            for (n, a), (_, b) in zip(_leaves(out[k]), _leaves(nudged[k])):
                leaves[n] = max(leaves.get(n, 0.0), float(np.abs(a - b).max()))
    worst = max((v, k, n) for k, leaves in floor.items() for n, v in leaves.items())
    assert worst[0] < FLOOR_CEILING, f"{request.param}: float32 noise floor {worst}"
    return dict(arch=request.param, cfg=cfg, params=params,
                toks=toks, nxt=nxt, kw=kw, floor=floor, **out)


def _port(f, *, f32=False, cfg=None):
    cfg = cfg or get_config(f["arch"]).reduced()
    lm = params_from_jax(LM(_f32_cfg(cfg) if f32 else cfg, device="cpu", seed=1),
                         f["params"])
    return lm.float() if f32 else lm


def _close(f, key, got):
    """The port's f32 output ``got`` against JAX's ``f[key]``, leaf by leaf,
    at atol 1e-4 plus three times JAX's own float32 noise floor there.  A
    one-step nudge of the weights moves an output about as far as float32
    rounding does (llava's train logits: 1.2e-3 under the nudge, 2.0e-3
    between JAX's f32 and a float64 evaluation); the two frameworks round
    differently from each other as well as from the exact value."""
    want = _leaves(f[key])
    got = _leaves(got)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (key, name)
        np.testing.assert_allclose(a, b, atol=1e-4 + 3 * f["floor"][key][name], rtol=0,
                                   err_msg=f"{key} {name}")


def _kw(f):
    return {k: torch.from_numpy(v) for k, v in f["kw"].items()}


def test_convert_carries_every_weight_exactly(family):
    f = family
    lm = _port(f)
    p = f["params"]
    n_port = sum(x.numel() for x in lm.parameters())
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(p))
    assert n_port == n_jax
    s_port = sum(float(x.double().sum()) for x in lm.parameters())
    s_jax = sum(float(np.asarray(x, np.float64).sum()) for x in jax.tree.leaves(p))
    assert abs(s_port - s_jax) <= 1e-9 * max(1.0, abs(s_jax))

    def eq(got, want):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))

    cfg = f["cfg"]
    if cfg.family == "hybrid":
        g = p["groups"]
        grp = lm.groups[0]
        eq(grp.ln_mix, g["ln_mix"][0])
        eq(grp.attn["wq"], g["attn"]["wq"][0])
        for j, m in enumerate(grp.mamba):
            eq(m["w_x"], g["mamba"]["w_x"][0, j])
        for j, m in enumerate(grp.moe):
            eq(m["w_gate"], g["moe"]["w_gate"][0, j])
            eq(m["router"], g["moe"]["router"][0, j])
        for j, m in enumerate(grp.dense_ffn):
            eq(m["w_down"], g["dense_ffn"]["w_down"][0, j])
        bad = dict(p, groups=dict(p["groups"], moe={k: v for k, v in g["moe"].items()
                                                     if k != "router"}))
        where = "groups.moe"
    else:
        for i, blk in enumerate(lm.blocks):
            eq(blk.attn["wk"], p["blocks"]["attn"]["wk"][i])
            if cfg.moe is not None:
                eq(blk.moe["w_up"], p["blocks"]["moe"]["w_up"][i])
                eq(blk.moe["router"], p["blocks"]["moe"]["router"][i])
        bad = dict(p, blocks=dict(p["blocks"], ln2=None))
        bad["blocks"].pop("ln2")
        where = "blocks"
    if cfg.encoder is not None:
        for i, blk in enumerate(lm.encoder):
            eq(blk.attn["wq"], p["encoder"]["attn"]["wq"][i])
            eq(blk.mlp["w_gate"], p["encoder"]["mlp"]["w_gate"][i])
        eq(lm.encoder_norm, p["encoder"]["final_norm"])
        for i, cb in enumerate(lm.cross):
            eq(cb.attn["wv"], p["cross"]["attn"]["wv"][i])
            eq(cb.ln, p["cross"]["ln"][i])
    with pytest.raises(ValueError, match=where):
        params_from_jax(LM(get_config(f["arch"]).reduced(), device="cpu"), bad)


def test_f32_train_prefill_and_cache_match_jax(family):
    f = family
    lm = _port(f, f32=True)
    toks = torch.from_numpy(f["toks"]).long()
    with torch.no_grad():
        train = lm.forward(toks, mode="train", **_kw(f))
        loss = lm.forward(toks, labels=toks, **_kw(f))["loss"]
        pf = lm.forward(toks, mode="prefill", kv_dtype="float32", **_kw(f))
    n_img = f["cfg"].num_image_tokens
    assert train["logits"].shape[1] == S + n_img
    _close(f, "train_logits", train["logits"].numpy())
    _close(f, "aux", train["aux_loss"].numpy())
    _close(f, "pf_logits", pf["logits"].numpy())
    _close(f, "pf_cache", _numpy(pf["cache"]))
    # the loss drops the image positions, as JAX's forward does
    logits = f["train_logits"][:, n_img:][:, :-1, :f["cfg"].vocab_size].astype(np.float64)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    picked = np.take_along_axis(logits, f["toks"][:, 1:, None].astype(np.int64), -1)[..., 0]
    want = np.mean(lse - picked) + 0.01 * float(f["aux"])
    assert abs(float(loss) - want) < 1e-4 + 3 * f["floor"]["train_logits"][""]


def test_f32_decode_step_from_jax_cache_matches_jax(family):
    f = family
    lm = _port(f, f32=True)
    cache = _torch(f["grown"])
    with torch.no_grad():
        logits, new = lm.decode(cache, torch.from_numpy(f["nxt"]).long(),
                                S + f["cfg"].num_image_tokens)
    assert new is cache                                  # written in place
    _close(f, "decode_logits", logits.numpy())
    _close(f, "decode_cache", _numpy(new))


def test_bf16_prefill_then_decode_matches_forward(family):
    f = family
    cfg = get_config(f["arch"]).reduced()
    if cfg.moe is not None:   # no capacity drops in the equivalence
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    lm = _port(f, cfg=cfg)
    toks, nxt = _inputs(cfg, seed=4)[:2]
    toks, nxt = torch.from_numpy(toks).long(), torch.from_numpy(nxt).long()
    n_img = cfg.num_image_tokens
    with torch.no_grad():
        full = lm.forward(torch.cat([toks, nxt], 1), mode="train", **_kw(f))["logits"]
        pf = lm.forward(toks, mode="prefill", kv_dtype="bfloat16", **_kw(f))
        cache = grow_cache(cfg, pf["cache"], 2 * S + n_img)
        shapes = [(n, x.shape) for n, x in _leaves(cache)]
        assert shapes == [(n, x.shape) for n, x in _leaves(lm.init_cache(B, 2 * S + n_img))]
        logits_d, new_cache = lm.decode(cache, nxt, S + n_img)
    a = full[:, -1, :cfg.vocab_size].float().numpy()
    b = logits_d[:, 0, :cfg.vocab_size].float().numpy()
    rel = np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-6)
    assert rel < 0.08, f"{f['arch']}: prefill/decode mismatch rel={rel:.4f}"
    assert [(n, x.shape) for n, x in _leaves(new_cache)] == shapes


def _rel(full, step, vocab):
    a = np.asarray(full, np.float32)[:, :vocab]
    b = np.asarray(step, np.float32)[:, :vocab]
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_vlm_serve_loops_first_decode_step(monkeypatch, capsys):
    """Both serve drivers on reduced llava, one decode step each, against a
    full forward of the prompt and the first token.  JAX's driver leaves
    the vlm cache at prefix + prompt (its ``grow`` pads only leaves of the
    prompt's length), so its first decode writes at the cache's length,
    which ``dynamic_update_slice`` clamps onto the last prompt slot, and
    its logits stray (rel 1.06 here).  The port grows the cache to
    prefix + prompt + new tokens and its step matches the forward."""
    from repro.launch import serve as jax_serve
    cfg = jax_get_config("llava-next-34b").reduced()
    n_img, seen = cfg.num_image_tokens, {}

    class JaxRecording(JaxLM):
        def init(self, key):          # the fixture's NumPy draw spares JAX's init compile
            return _draw_params(self.param_specs())

        def forward(self, params, tokens, **kw):
            seen.setdefault("prefill", (params, tokens, kw))
            return super().forward(params, tokens, **kw)

        def decode(self, params, cache, token, pos):
            seen["cache_len"] = jax.tree.leaves(cache)[0].shape[2]
            logits, new = super().decode(params, cache, token, pos)
            jax.debug.callback(lambda x: seen.setdefault("step", np.asarray(x)), logits)
            return logits, new

    class PortRecording(LM):
        def decode(self, cache, token, pos):
            seen["port_cache_len"] = cache["k"].shape[2]
            logits, new = super().decode(cache, token, pos)
            seen.setdefault("port_step", logits.clone())
            return logits, new

    argv = ["--arch", "llava-next-34b", "--reduced", "--batch", "2", "--prompt-len", "8",
            "--gen", "2"]
    monkeypatch.setattr(jax_serve, "LM", JaxRecording)
    toks = jax_serve.main(argv)
    params, prompts, kw = seen["prefill"]
    mesh = single_device_mesh()
    with mesh:
        lm_j = JaxLM(cfg, jax_make_plan(cfg, mesh))
        full = lm_j.forward(params, jnp.concatenate([prompts, jnp.asarray(toks[:, :1])], 1),
                            mode="train", embeds_prefix=kw["embeds_prefix"])["logits"][:, -1]
    assert seen["cache_len"] == 8 + n_img               # decode pos 8 + n_img is past it
    rel_jax = _rel(full, seen["step"][:, -1], cfg.vocab_size)

    monkeypatch.setattr(serve, "LM", PortRecording)
    res = serve.run(argv + ["--device", "cpu"])
    with torch.no_grad():
        full = res.lm.forward(torch.cat([res.prompts, torch.as_tensor(res.tokens[:, :1])], 1),
                              mode="train", **res.inputs)["logits"][:, -1]
    assert seen["port_cache_len"] == 8 + n_img + 2
    rel_port = _rel(full.float(), seen["port_step"][:, -1].float(), cfg.vocab_size)
    assert rel_port < 0.08 < rel_jax, (rel_port, rel_jax)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"])
    assert toks.shape == (2, 3) and toks.min() >= 0 and toks.max() < 256
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"[serve] arch={arch}")


def test_serve_run_takes_a_depth_cut_only(capsys):
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "2"]
    res = serve.run(args, cfg=dataclasses.replace(cfg, num_layers=2))
    assert len(res.lm.blocks) == 2 and res.tokens.shape == (2, 2)
    assert "depth cut to 2 of 4 layers" in capsys.readouterr().out
    with pytest.raises(ValueError, match="only the depth"):
        serve.run(args, cfg=dataclasses.replace(cfg, d_model=32))
    jamba = get_config("jamba-1.5-large-398b").reduced()
    with pytest.raises(AssertionError):      # not a multiple of attn_period
        serve.run(args, cfg=dataclasses.replace(jamba, num_layers=4))
