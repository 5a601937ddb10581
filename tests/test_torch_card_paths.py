"""The port's paths on the card, end to end: each family served at full
width, a train step, the duet pipeline and the command line on the kernel
suite, the examples, and cells on a one-device mesh.

* Serve (``launch.serve.run``, batch 4, 32 new tokens, seeded random bf16
  weights), one case per family, each cut in depth as ``FAMILIES`` says:
  the kernel launches by kernel and variant (K1 once per self-attention
  layer of the prefill, the encoder's non-causal; K2 and K4 once per
  Mamba-2 layer; none in decode), every K1 call a self-attention one, the decode
  positions, the tokens and finite logits.  At full width the reference's
  init gives attention scores of std ~180, so two paths that differ only in
  rounding drift apart over many layers: the model-level checks (prefill
  then one decode step against the full forward, rel < 0.08; flash against
  dot prefill) run on the same width cut to 1 layer (the whole reduced
  Jamba), with capacity_factor 16 so that no MoE token is dropped.
* Train: one step of internlm2-1.8b and mamba2-1.3b cut to 1 layer at full
  width, f32: the card against the port on the CPU, remat "dots" against
  "none", and for mamba2 ``SSDScanFn``'s gradient against the plain scan's
  and the bf16 step (K2 "wg") against the f32 one; a restart from a
  checkpoint; the int8 optimizer state.
* The kernel-duet suite on the card through ``Pipeline``, the command line
  (with and without the observability flags, and refused under ``--jobs``),
  ``benchmarks.run``'s duet table and the quickstart example.
* The serve_batch and train_lm examples on the card.
* ``launch.cells.build_cell`` on a 1x1 mesh on the card at full width.
* K4 in a reduced mamba2 and a reduced granite prefill: one launch per
  Mamba-2 layer, each ``conv`` span noting it, the logits held to the plain
  route's.

The numbers that are host-only and seeded (the command line's synthetic
and service runs, the paper tables, the watch tool, the benchmark scripts)
are held to the JAX package's on the CPU by the other ``test_torch_*``
files.  This file needs no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/

Without a card every test skips before it builds anything.
"""
import dataclasses
import gc
import json
import math
import re

import pytest

torch = pytest.importorskip("torch")

from _torch_card import Launches, agreement, skip_without_card  # noqa: E402

GEN = 32
# arch: (serve flags, decoder layers kept, or None for all)
FAMILIES = {
    "internlm2-1.8b": (["--prompt-len", "1024"], None),
    "mamba2-1.3b": (["--prompt-len", "1024"], None),
    "phi3.5-moe-42b-a6.6b": (["--prompt-len", "1024"], 8),
    "whisper-medium": (["--prompt-len", "32"], None),
    "llava-next-34b": (["--prompt-len", "1024"], 8),
    # full width needs more than one card: one 8-layer period is ~88 GB of bf16 weights
    "jamba-1.5-large-398b": (["--prompt-len", "1024", "--reduced"], None),
}
# the 1-layer checks beyond bf16 prefill -> decode: "f32" the same in f32,
# "flash" flash against dot (train mode in bf16, and prefill in f32 with "f32")
ONE_LAYER_CHECKS = {"internlm2-1.8b": ("f32", "flash"), "mamba2-1.3b": ("f32",),
                    "phi3.5-moe-42b-a6.6b": ("flash",), "llava-next-34b": ("flash",)}
MOE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}    # tests/test_moe.py:39-41; K1's bf16 twin


@pytest.fixture(autouse=True)
def _free_the_card():
    yield
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _consistency(lm, prompts, nxt, kv_dtype, inputs):
    """rel. max difference of the last logits: the full forward against
    prefill followed by one decode step (tests/test_models_smoke.py:58-93).
    ``inputs`` holds the enc-dec family's frames or the vlm's image prefix,
    which shifts the decode position by its length."""
    from repro_torch.launch.serve import grow_cache
    cfg = lm.cfg
    S = prompts.shape[1] + (inputs["embeds_prefix"].shape[1] if "embeds_prefix" in inputs else 0)
    full = lm.forward(torch.cat([prompts, nxt], 1), mode="train", **inputs)["logits"]
    pf = lm.forward(prompts, mode="prefill", kv_dtype=kv_dtype, **inputs)
    logits_d, _ = lm.decode(grow_cache(cfg, pf["cache"], 2 * S), nxt, S)
    a = full[:, -1, :cfg.vocab_size].float()
    b = logits_d[:, 0, :cfg.vocab_size].float()
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-6))


def _assert_flash_close_to_dot(lm, tokens, mode, inputs):
    """Flash logits against dot logits (``_assert_logits_close``)."""
    cfg = lm.cfg
    flash = lm.forward(tokens, mode=mode, **inputs)["logits"][..., :cfg.vocab_size].float()
    lm.cfg = dataclasses.replace(cfg, attention_impl="dot")
    try:
        dot = lm.forward(tokens, mode=mode, **inputs)["logits"][..., :cfg.vocab_size].float()
    finally:
        lm.cfg = cfg
    _assert_logits_close(flash, dot)


def _assert_logits_close(got, want):
    """bf16 logits of two routes by the measures of
    tests/test_integration_extras.py:33-37."""
    diff = (got - want).abs()
    close = dict(mean_abs=float(diff.mean()), frac_lt_025=float((diff < 0.25).float().mean()),
                 argmax_agree=float((got.argmax(-1) == want.argmax(-1)).float().mean()))
    assert (close["mean_abs"] < 0.05 and close["frac_lt_025"] > 0.99
            and close["argmax_agree"] > 0.95), close


def _one_layer(cfg):
    """``cfg`` cut to 1 layer (and 1 encoder layer), capacity_factor 16 (as
    tests/test_models_smoke.py:63-66 sets it); the reduced hybrid whole."""
    if cfg.hybrid is not None:
        kw = {}
    else:
        kw = {"num_layers": 1}
        if cfg.encoder is not None:
            kw["encoder"] = dataclasses.replace(cfg.encoder, num_layers=1)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=16.0)
    return dataclasses.replace(cfg, **kw)


def _assert_moe_index_path_is_the_dense_oracle(lm):
    """The index-buffer MoE against the dense oracle at the serve shape of
    one phi3.5-moe layer (T = 4 x 1024, E 16, top-2) with that layer's
    experts: f32 at atol = rtol = 1e-4, bf16 within 3e-2 of the largest
    |y|.  Both share the router, so only the order of the sums differs."""
    from repro_torch.models import moe as moe_mod
    cfg = lm.cfg
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((4, 1024, cfg.d_model), generator=g, device="cuda")
    params = dict(lm.blocks[0].moe)
    for dtype, tol in MOE_TOL.items():
        dt = getattr(torch, dtype)
        p = {k: v.to(dt) for k, v in params.items()}
        with torch.inference_mode():
            y, _ = moe_mod.moe_ffn_index(x.to(dt), p, cfg.moe)
            y_ref, _ = moe_mod.moe_ffn_dense(x.to(dt), p, cfg.moe)
        err = (y.float() - y_ref.float()).abs()
        assert torch.isfinite(err).all()
        if dtype == "float32":
            assert agreement(y.float(), y_ref.float(), tol)[2] == 0
        else:
            assert float(err.max()) <= tol * float(y_ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_a_family_serves_on_card(arch, monkeypatch):
    skip_without_card("the serve path launches the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import k1_variant
    from repro_torch.kernels.ssd_scan import k2_variant
    from repro_torch.launch import serve
    from repro_torch.models import decode_graph
    from repro_torch.models.lm import LM
    flags, layers = FAMILIES[arch]
    cfg = None if layers is None else dataclasses.replace(get_config(arch), num_layers=layers)
    calls, positions = [], []
    flash, decode = kops.flash_attention, LM.decode

    def record_flash(q, k, v, **kw):
        calls.append((kw.get("causal", True), tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    def record_decode(lm, cache, token, pos):
        positions.append(int(pos))
        return decode(lm, cache, token, pos)

    monkeypatch.setattr(kops, "flash_attention", record_flash)
    monkeypatch.setattr(LM, "decode", record_decode)
    steps = dict(decode_graph.COUNTS)
    launches = Launches()
    res = serve.run(["--arch", arch, "--batch", "4", "--gen", str(GEN), "--attention-impl",
                     "flash", "--kv-dtype", "bfloat16", "--seed", "0", "--device", "cuda",
                     *flags], cfg=cfg)
    monkeypatch.undo()
    ran = {how: decode_graph.COUNTS[how] - steps[how] for how in steps}
    total, by_variant = launches.total(), launches.by_variant()
    cfg = res.lm.cfg

    # launches: K1 once per self-attention layer of the prefill (and per
    # encoder layer), K2 once per Mamba-2 layer, on the tensor cores
    n_attn = (cfg.num_layers // cfg.hybrid.attn_period if cfg.hybrid
              else 0 if cfg.ssm is not None else cfg.num_layers)
    n_enc = cfg.encoder.num_layers if cfg.encoder else 0
    want_k1, want_k2 = n_attn + n_enc, cfg.num_layers - n_attn
    if want_k1:
        assert total["K1"] == by_variant["K1"][k1_variant(torch.bfloat16, cfg.head_dim)] == want_k1
    else:
        assert total["K1"] == 0
    if want_k2:
        k2v = k2_variant(torch.bfloat16, cfg.ssm.head_dim, cfg.ssm.d_state)
        assert total["K2"] == by_variant["K2"][k2v] == want_k2
    else:
        assert total["K2"] == 0
    assert total["K4"] == want_k2       # x, B and C of each Mamba-2 layer in one launch
    S = res.prompts.shape[1] + cfg.num_image_tokens
    assert len(calls) == want_k1
    assert all(q[1] == k[1] for _, q, k in calls)               # no cross-attention takes K1
    assert sum(not causal for causal, _, _ in calls) == n_enc    # non-causal: the encoder
    assert all(q[1] == S for causal, q, _ in calls if causal)
    assert positions == list(range(S, S + GEN - 1))
    assert sum(ran.values()) == GEN - 1
    if arch == "internlm2-1.8b":
        # K3's wrapper runs once per layer in each eager or captured step; a
        # replay calls no wrapper
        called = (ran["eager"] + ran["capture"]) * cfg.num_layers
        assert ran["replay"] > 0
        assert by_variant["K3"]["split"] == called
        assert by_variant["K3"]["combine"] in (0, called)
    if cfg.ssm is not None and n_attn == 0:
        assert total["K3"] == 0
    assert tuple(res.tokens.shape) == (4, GEN)
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size
    assert torch.isfinite(res.prefill_logits[..., :cfg.vocab_size].float()).all()
    if cfg.moe is not None and cfg.hybrid is None:
        _assert_moe_index_path_is_the_dense_oracle(res.lm)

    prompts, inputs = res.prompts, res.inputs
    del res
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(5)
    nxt = torch.randint(0, cfg.vocab_size, (prompts.shape[0], 1), generator=g, device="cuda")
    checks = ONE_LAYER_CHECKS.get(arch, ())
    with torch.inference_mode():
        short = LM(_one_layer(cfg), device="cuda", seed=0)
        assert _consistency(short, prompts, nxt, "bfloat16", inputs) < 0.08
        if "flash" in checks:
            # llava's dot path at 3,904 positions holds [B, K, G, S, S] f32
            # scores (13.7 GB at batch 4): batch 1 there
            b = 1 if cfg.num_image_tokens else prompts.shape[0]
            _assert_flash_close_to_dot(short, prompts[:b], "train",
                                       {k: v[:b] for k, v in inputs.items()})
        if "f32" in checks:
            short.float()
            assert _consistency(short, prompts, nxt, "float32", inputs) < 0.08
            if "flash" in checks:
                _assert_flash_close_to_dot(short, prompts, "prefill", inputs)


# ------------------------------------------------------------------- train
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)       # per leaf: |g - g_ref| <= rtol |g_ref| + atol
REMAT_TOL = 1e-6                            # dots against none: relative, loss and each leaf
# the bf16 step (K2 "wg") against the f32 step, per leaf, relative to the
# f32 gradient's norm: K2's own bf16 tolerance; a gradient through one bf16
# layer carries errors of the same order as its output
BF16_GRAD_TOL = 5e-2


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
        out[key] = float((got[key].double().cpu() - w).norm()) / (rtol * float(w.norm()) + atol)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-1.3b"])
def test_a_one_layer_train_step_on_card(arch, monkeypatch):
    """One step's loss and gradients at full width cut to 1 layer, batch
    2 x 256, f32 with TF32 off: every leaf's gradient nonzero; K1 never
    launched (training takes the chunked attention) and K2 "fma" once, its
    forward (remat "dots" keeps its outputs); remat "dots" against "none";
    for mamba2 the gradient through ``SSDScanFn`` against autograd through
    the plain scan on the card, and the bf16 step (K2's "wg" once) against
    the f32 one; and the card against the same port on the CPU."""
    skip_without_card("the step launches the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.lm import LM
    from repro_torch.train import data as data_mod
    cfg = dataclasses.replace(get_config(arch), num_layers=1, dtype="float32")
    ds = data_mod.SyntheticDataset(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=256, global_batch=2, accum_steps=1), cfg)
    host_batch = ds.batch(0)
    batch = data_mod.batch_to_device(host_batch, "cuda")
    lm = LM(cfg, device="cuda", seed=0)
    bf16_state = {k: v.clone() for k, v in lm.state_dict().items()}
    lm.float().requires_grad_(True)
    ssm = cfg.family == "ssm"
    launches = Launches()
    loss, grads = _grads_of(lm, batch)
    assert launches.total()["K1"] == 0
    assert launches.by_variant()["K2"] == {"wg": 0, "tc": 0, "fma": 1 if ssm else 0}
    assert not [k for k, g in grads.items() if not bool(g.abs().max() > 0)]

    lm.cfg = dataclasses.replace(cfg, remat="none")
    loss_none, grads_none = _grads_of(lm, batch)
    lm.cfg = cfg
    assert abs(loss - loss_none) / abs(loss_none) <= REMAT_TOL
    assert max(_grad_shares(grads, grads_none, REMAT_TOL).values()) <= 1

    if ssm:
        monkeypatch.setattr(ssm_mod, "ssd_scan_hmajor", ssd_scan.ssd_scan_hmajor_plain)
        launches = Launches()
        _, grads_plain = _grads_of(lm, batch)
        monkeypatch.undo()
        assert launches.total()["K2"] == 0
        assert max(_grad_shares(grads, grads_plain, **GRAD_TOL).values()) <= 1
        lm_bf = LM(dataclasses.replace(cfg, dtype="bfloat16"), device="cuda", seed=0)
        lm_bf.load_state_dict(bf16_state)
        lm_bf.requires_grad_(True)
        launches = Launches()
        _, grads_bf = _grads_of(lm_bf, batch, "bfloat16")
        assert launches.by_variant()["K2"] == {"wg": 1, "tc": 0, "fma": 0}
        assert max(_grad_shares(grads_bf, grads, BF16_GRAD_TOL).values()) <= 1
        del lm_bf, grads_bf

    lm_cpu = LM(cfg, device="cpu", seed=0).float()
    lm_cpu.load_state_dict(lm.state_dict())
    lm_cpu.requires_grad_(True)
    loss_cpu, grads_cpu = _grads_of(lm_cpu, data_mod.batch_to_device(host_batch, "cpu"))
    assert abs(loss - loss_cpu) / abs(loss_cpu) <= GRAD_TOL["rtol"]
    assert max(_grad_shares(grads, grads_cpu, **GRAD_TOL).values()) <= 1


def _train(argv, ocfg):
    """``launch.train.main(argv, ocfg=ocfg)`` and its standard output."""
    import contextlib
    import io
    from repro_torch.launch import train
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = train.main(argv, ocfg=ocfg)
    return res, text.getvalue()


@pytest.mark.cuda
def test_training_resumes_from_a_checkpoint_on_card(tmp_path):
    """Reduced internlm2, lr 1e-2, warmup 5, no weight decay
    (tests/test_system.py:25-39): 14 steps with a checkpoint at step 12;
    step 12 copied into a second directory, the same command resumes from
    it, and both step_14 checkpoints are equal byte for byte."""
    skip_without_card("the train entry point runs on the card")
    import shutil
    from repro_torch.train.optimizer import OptimizerConfig
    a, b = tmp_path / "a", tmp_path / "b"
    ocfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=5, weight_decay=0.0, total_steps=14)
    argv = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "14", "--ckpt-every", "12",
            "--log-every", "100", "--device", "cuda"]
    _train([*argv, "--ckpt-dir", str(a)], ocfg)
    shutil.copytree(a / "step_12", b / "step_12")
    res_b, out = _train([*argv, "--ckpt-dir", str(b)], ocfg)
    assert "resumed from step 12" in out and res_b.start_step == 12
    files = sorted(p.name for p in (a / "step_14").iterdir())
    assert files == sorted(p.name for p in (b / "step_14").iterdir())
    assert [f for f in files
            if (a / "step_14" / f).read_bytes() != (b / "step_14" / f).read_bytes()] == []


# the int8 path's master and parameters against the f32 path's from the same
# decoded state, per leaf relative to the leaf's largest entry (the same
# float32 operations on the same values: equal but for rounding); its new
# codes decode within Q8_CODE_SHARE of half a block scale s of the f32
# path's new m and sqrt(v): round to nearest leaves s / 2, and the float32
# roundings of x / s and of q * s (|q| <= 127) add up to 127 s 2^-24 each,
# so the share is at most 1 + 4 * 127 * 2^-24, plus 3 roundings of the
# comparison itself
Q8_MASTER_TOL = 1e-6
Q8_CODE_SHARE = 1 + (4 * 127 + 3) * 2.0 ** -24


def _q8_decode_here(q8):
    """Int8 state {"q", "scale"} as f32: each block of 256 flattened codes
    times its scale, written apart from ``quantized_state.q8_decode`` so
    that a fault there shows against it."""
    from repro_torch.train.quantized_state import BLOCK
    q, scale = q8["q"], q8["scale"]
    per_entry = scale.repeat_interleave(BLOCK)[:q.numel()].view(q.shape)
    return q.float() * per_entry, per_entry


@pytest.mark.cuda
def test_the_int8_optimizer_state_on_card():
    """Reduced internlm2, 2 steps with int8 m and v against 2 with f32, each
    step's loss and gradient norm finite: the first update starts from zero
    m and v, so step 2's loss is the f32 run's within 1e-2; m and v take
    int8 codes and an f32 scale per block.
    Then one more AdamW update from the int8 run's state, made twice from
    that state and one seeded N(0, 1) gradient: by the int8 path, and by
    the f32 path from m and sqrt(v) decoded with ``_q8_decode_here``.  A
    fault in the int8 path's decode moves its master and parameters off the
    f32 path's (``Q8_MASTER_TOL``); a fault in its encode moves its new codes
    more than half a block scale off the f32 path's new m and sqrt(v)
    (``Q8_CODE_SHARE``)."""
    skip_without_card("the train entry point runs on the card")
    from repro_torch.train.optimizer import OptimizerConfig, apply_updates_
    from repro_torch.train.quantized_state import n_blocks, state_bytes
    from repro_torch.train.tree import items, tree_map
    argv = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "2", "--log-every", "100",
            "--device", "cuda"]
    runs = {bits: _train(argv, OptimizerConfig(learning_rate=3e-4, warmup_steps=1,
                                               total_steps=4, state_bits=bits))[0]
            for bits in (32, 8)}
    assert all(len(r.steps) == 2 and math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for r in runs.values() for m in r.steps)
    losses = [r.steps[1]["loss"] for r in (runs[32], runs[8])]
    assert abs(losses[1] - losses[0]) / abs(losses[0]) <= 1e-2
    res = runs[8]
    del runs
    params, opt, ocfg = res.state["params"], res.state["opt"], res.ocfg
    keys = [k for k, _ in items(params)]
    assert state_bytes({"m": opt["m"], "v": opt["v"]}) == 2 * sum(
        p.numel() + 4 * n_blocks(p.shape) for _, p in items(params))

    g = torch.Generator(device="cuda").manual_seed(12)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g, device="cuda"), params)
    ref = {"m": tree_map(lambda p, q: _q8_decode_here(q)[0], params, opt["m"]),
           "v": tree_map(lambda p, q: _q8_decode_here(q)[0].square_(), params, opt["v"]),
           "master": tree_map(torch.clone, opt["master"]), "step": opt["step"].clone()}
    ref_params = tree_map(torch.clone, params)
    apply_updates_(ref_params, grads, ref, dataclasses.replace(ocfg, state_bits=32))
    apply_updates_(params, grads, opt, ocfg)
    got_p, want_p = dict(items(params)), dict(items(ref_params))
    paired = []
    tree_map(lambda p, *t: paired.append(t), params, opt["m"], ref["m"], opt["v"], ref["v"],
             opt["master"], ref["master"])
    for key, (m, want_m, v, want_v, master, want_master) in zip(keys, paired):
        off = max(float((master - want_master).abs().max()),
                  float((got_p[key].float() - want_p[key].float()).abs().max()))
        assert off <= Q8_MASTER_TOL * (float(want_master.abs().max()) or 1.0), key
        for q8, want in ((m, want_m), (v, want_v.sqrt())):
            dec, per_entry = _q8_decode_here(q8)
            assert float(((dec - want).abs() / (0.5 * per_entry)).max()) <= Q8_CODE_SHARE, key


# ------------------------------------------------- the kernel-duet suite
CB_CALLS = 12        # calls per benchmark
# v1 against v2 of each duet, at the JAX tests' tolerances (tests/
# test_attention.py:28, tests/test_ssm.py:32; rms_norm in float32)
DUET_TOLERANCE = {"attention_dot_vs_chunked": 1e-5, "ssd_recurrence_vs_chunked": 1e-4,
                  "rmsnorm_fused_vs_unfused": 1e-5}


def _in_process(fn, argv):
    """``fn(argv)`` with its standard output captured: (exit code, stdout,
    launches by kernel, wall s).  The process-wide observability context
    and default engine that an entry point installs are put back after."""
    import contextlib
    import io
    import time
    from repro_torch.faas import engine_vec
    from repro_torch.obs import get_obs, set_obs
    saved = get_obs(), engine_vec._DEFAULT_ENGINE
    launches = Launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            ret = fn(argv)
        code = ret if isinstance(ret, int) else 0
    except SystemExit as e:
        code = e.code
    finally:
        set_obs(saved[0])
        engine_vec.set_default_engine(saved[1])
    return code, out.getvalue(), launches, time.perf_counter() - t0


def _duets():
    """Each duet's two versions once on the card at the suite's default
    shapes, held to each other; the SSD duet's chunked side is K2 "fma"."""
    from repro_torch.benchmarks import kernel_bench as kb
    launches = Launches()
    for name, v1, v2, draw, _ in kb.DUETS:
        inputs = draw(device=torch.device("cuda"))
        before = launches.total()["K2"]
        a, b = v1(*inputs), v2(*inputs)
        torch.cuda.synchronize()
        if name == "ssd_recurrence_vs_chunked":
            a = a.movedim(1, 2)     # the recurrence's y is head-major
            assert launches.total()["K2"] == before + 1
        assert a.shape == b.shape and a.is_cuda and b.is_cuda
        assert torch.isfinite(b).all()
        assert agreement(a.float(), b.float(), DUET_TOLERANCE[name])[2] == 0, name
    return launches


def _pipeline():
    """``Pipeline(get_suite("kernels", device="cuda"))`` over
    ``kernel_commits()``: every benchmark with all its pairs, finite positive
    timings and one history record; the engine times each duet on a worker
    thread, whose current CUDA stream must be the default stream."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.cb import Pipeline, PipelineConfig, get_suite
    from repro_torch.cb.history import SOURCE_RUN
    suite = get_suite("kernels", device="cuda")
    with ThreadPoolExecutor(1) as pool:
        worker_stream = pool.submit(lambda: torch.cuda.current_stream().cuda_stream).result()
    assert worker_stream == torch.cuda.default_stream().cuda_stream
    reports = []      # the suite's run results: their engine reports hold the pairs
    suite_run = suite.run
    suite.run = lambda *a, **kw: reports.append(suite_run(*a, **kw)) or reports[-1]
    pipe = Pipeline(suite, PipelineConfig(
        suite="kernels", provider="local", mode="selective", n_calls=CB_CALLS,
        repeats_per_call=1, parallelism=1, min_results=10))
    launches = Launches()
    rep = pipe.run_stream(kb.kernel_commits())
    names = suite.benchmark_names()
    (run,) = rep.commits
    assert sorted(run.ran) == names and len(reports) == 1
    report = reports[0].report
    assert not report.failed_benchmarks
    assert sorted(run.changes) == names
    assert all(c.n_pairs == CB_CALLS for c in run.changes.values())
    assert run.invocations == CB_CALLS * len(run.ran)
    recs = [r for r in pipe.history.records() if r.source == SOURCE_RUN]
    assert sorted(r.benchmark for r in recs) == names
    assert all(r.invocations == CB_CALLS and r.billed_seconds > 0 for r in recs)
    assert all(math.isfinite(t) and t > 0 for p in report.pairs
               for t in (p.v1_seconds, p.v2_seconds))
    return launches


def _cli_kernels(tmp_path, observed):
    """``--suite kernels`` through the command line: one summary of one
    commit and every duet's calls, a history record per benchmark; with the
    four observability flags, a valid trace whose only span is the
    commit's and covers the run, the commit and selection counters, and
    the exit code the health verdict implies."""
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.cb import cli
    from repro_torch.cb.history import SOURCE_RUN, HistoryStore
    from repro_torch.obs import validate_chrome_trace
    history = tmp_path / "history.jsonl"
    paths = {k: tmp_path / f"{k}.json" for k in ("trace", "metrics", "health")}
    flags = (["--trace", str(paths["trace"]), "--metrics-out", str(paths["metrics"]), "--slo",
              "--health-out", str(paths["health"])] if observed else [])
    code, out, launches, wall = _in_process(cli.main, [
        "--suite", "kernels", "--n-calls", str(CB_CALLS), "--repeats", "1", "--parallelism",
        "1", "--history", str(history), *flags])
    names = sorted(name for name, *_ in kb.DUETS)
    summaries = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert len(summaries) == 1 and summaries[0]["commits"] == 1
    assert summaries[0]["invocations"] == CB_CALLS * len(names)
    runs = [r for r in HistoryStore(str(history)).records() if r.source == SOURCE_RUN]
    assert sorted(r.benchmark for r in runs) == names
    assert all(r.invocations == CB_CALLS for r in runs)
    if not observed:
        assert code == 0
        return launches
    from repro_torch.cb.cli import EXIT_BREACH, resolve_exit_code
    trace = json.loads(paths["trace"].read_text())
    events = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    assert validate_chrome_trace(trace) == []
    assert [(e["ph"], e.get("cat")) for e in events] == [("X", "commit")]
    assert abs(events[0]["dur"] / 1e6 / wall - 1.0) <= 0.25
    counters = {c["name"]: (c["labels"], c["value"])
                for c in json.loads(paths["metrics"].read_text())["counters"]}
    assert counters["cb.commits"] == ({"provider": "local"}, 1.0)
    assert counters["cb.benchmarks_selected"] == ({"provider": "local"}, float(len(names)))
    verdict = json.loads(paths["health"].read_text())["verdict"]
    assert verdict in ("healthy", "warn", "breach")
    assert code == resolve_exit_code(0, EXIT_BREACH if verdict == "breach" else 0)
    return launches


def _refused_under_jobs():
    """``--suite kernels --jobs 2``: the service takes no kernel suite."""
    from repro_torch.cb import cli
    from repro_torch.cb.cli import EXIT_INFEASIBLE
    code, _, launches, _ = _in_process(cli.main, ["--suite", "kernels", "--jobs", "2"])
    assert code == EXIT_INFEASIBLE
    return launches


def _duet_table():
    """``benchmarks.run --tables kernel_duets`` on the card: each duet's
    pairs, a finite median and CI."""
    from repro_torch.benchmarks import run
    code, out, launches, _ = _in_process(run.main, ["--tables", "kernel_duets"])
    rows = [line for line in out.splitlines() if line.startswith("kernel_duets_real,")]
    assert code == 0 and len(rows) == 1
    duets = json.loads(rows[0].split(",", 2)[2])
    for name in DUET_TOLERANCE:
        d = duets[name]
        assert d["n"] == CB_CALLS
        assert all(math.isfinite(x) for x in [d["median_diff_pct"], *d["ci"]])
    return launches


def _quickstart():
    """The quickstart example on the card: one verdict line."""
    from repro_torch.examples import quickstart
    code, out, launches, _ = _in_process(quickstart.main, ["--device", "cuda"])
    lines = out.splitlines()
    assert code == 0 and len(lines) == 2
    assert re.fullmatch(r"attention_dot_vs_chunked: median diff [+-]\d+\.\d% \(99% CI "
                        r"\[[+-]\d+\.\d%, [+-]\d+\.\d%\]\) over 15 duet pairs -> "
                        r"(PERFORMANCE CHANGE|no change)", lines[0]), lines[0]
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["duets", "pipeline", "cli", "cli_observed",
                                   "refused_under_jobs", "duet_table", "quickstart"])
def test_the_kernel_suite_runs_on_card(entry, tmp_path):
    """Each entry point that runs the kernel-duet suite, on the card: the
    SSD duet's chunked side (f32) launches K2 "fma" at least once and
    nothing launches K1 (the attention duet's sides are plain PyTorch); the
    quickstart, which runs the attention duet alone, launches neither, and
    the service refuses the suite before it launches anything."""
    skip_without_card("the kernel-duet suite times real calls on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {"duets": _duets, "pipeline": _pipeline,
                "cli": lambda: _cli_kernels(tmp_path, False),
                "cli_observed": lambda: _cli_kernels(tmp_path, True),
                "refused_under_jobs": _refused_under_jobs, "duet_table": _duet_table,
                "quickstart": _quickstart}[entry]()
    total = launches.total()
    if entry in ("refused_under_jobs", "quickstart"):
        assert not any(total.values()), total
    else:
        assert total["K1"] == 0 and total["K2"] >= 1, total
        assert launches.by_variant()["K2"]["fma"] == total["K2"]


# ---------------------------------------------------------------- examples
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-1.3b"])
def test_the_serve_batch_example_on_card(arch, monkeypatch):
    """The serve_batch example (the reduced model, batch 4, prompt 32, 16 new
    tokens, as the JAX example serves it): K1 (internlm2) or K2 (mamba2)
    once per prefill layer on "tc" (``reduced()``'s head dims), none in
    decode; finite logits; and the kernel held against its plain version on
    the inputs the model gave its first call."""
    skip_without_card("the example serves on the card")
    from repro_torch.examples import serve_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.launch import serve
    from repro_torch.models import ssm as ssm_mod
    kept, first = {}, {}
    real_run, real_k1, real_k2 = serve.run, kops.flash_attention, ssm_mod.ssd_scan_hmajor

    def keep(argv, *, cfg=None):
        kept["res"] = real_run(argv, cfg=cfg)
        return kept["res"]

    def grab_k1(q, k, v, *, causal=True, window=None, softmax_scale=None):
        first.setdefault("K1", (tuple(t.transpose(1, 2).contiguous() for t in (q, k, v)),
                                dict(causal=causal, window=0 if window is None else int(window),
                                     softmax_scale=softmax_scale)))
        return real_k1(q, k, v, causal=causal, window=window, softmax_scale=softmax_scale)

    def grab_k2(x, dt, A, B, C, **kw):
        first.setdefault("K2", (tuple(t.clone() for t in (x, dt, A, B, C)), dict(kw)))
        return real_k2(x, dt, A, B, C, **kw)

    monkeypatch.setattr(serve, "run", keep)
    monkeypatch.setattr(kops, "flash_attention", grab_k1)
    monkeypatch.setattr(ssm_mod, "ssd_scan_hmajor", grab_k2)
    code, _, launches, _ = _in_process(serve_batch.main, ["--arch", arch, "--device", "cuda"])
    monkeypatch.undo()
    res = kept["res"]
    cfg = res.lm.cfg
    kernel = "K1" if cfg.family != "ssm" else "K2"
    variant = (fa.k1_variant(torch.bfloat16, cfg.head_dim) if kernel == "K1"
               else ks.k2_variant(torch.bfloat16, cfg.ssm.head_dim, cfg.ssm.d_state))
    assert code == 0 and variant == "tc"
    total = launches.total()
    assert {k: total[k] for k in ("K1", "K2")} == {"K1": 0, "K2": 0, kernel: cfg.num_layers}
    assert launches.by_variant()[kernel][variant] == cfg.num_layers
    assert tuple(res.tokens.shape) == (4, 16)
    assert torch.isfinite(res.prefill_logits[..., :cfg.vocab_size].float()).all()
    args, kw = first[kernel]
    if kernel == "K1":
        pairs = [(fa.flash_attention_hmajor(*args, **kw),
                  fa.flash_attention_hmajor_plain(*args, **kw))]
    else:
        pairs = list(zip(ks.ssd_scan_hmajor(*args, **kw), ks.ssd_scan_hmajor_plain(*args, **kw)))
    tol = {"K1": 3e-2, "K2": 5e-2}[kernel]
    for a, b in pairs:
        assert torch.isfinite(a.float()).all()
        assert agreement(a.float(), b.float(), tol)[2] == 0


@pytest.mark.cuda
def test_the_train_lm_example_on_card(tmp_path):
    """The train_lm example on the card: its 200 steps' losses finite, the
    last below the first."""
    skip_without_card("the example trains on the card")
    from repro_torch.examples import train_lm
    res = []
    code, _, _, _ = _in_process(lambda argv: res.append(train_lm.main(argv)), [
        "--device", "cuda", "--ckpt-dir", str(tmp_path / "train_lm")])
    losses = [s["loss"] for s in res[0].steps]
    assert code == 0 and len(losses) == 200 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0]


# ------------------------------------------------------------------- cells
# cells built by ``launch.cells.build_cell`` on a 1x1 mesh on the card, full
# width, seeded random bf16 weights: (arch, shape, global batch or None for
# the shape's own, config overrides, launches of one run by kernel and
# variant; "k2" stands for ``k2_variant``'s choice at the model's widths)
CELLS = [
    ("internlm2-1.8b", "prefill_32k", 1, {"attention_impl": "flash"}, {"K1": {"wg": 24}}),
    ("mamba2-1.3b", "prefill_32k", 1, None, {"K2": {"k2": 48}}),
    ("internlm2-1.8b", "decode_32k", 32, None, {}),       # int8 cache: ~53 GB at batch 32
    ("mamba2-1.3b", "decode_32k", None, None, {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape,batch,overrides,want", CELLS,
                         ids=[f"{c[0]}-{c[1]}" for c in CELLS])
def test_a_cell_runs_on_a_one_device_mesh_on_card(arch, shape, batch, overrides, want):
    """One run of the cell with the kernels' launches counted (K1 and K2 as
    ``want``, nothing else of them), its logits finite; and the account of
    the same call (``analysis.account``) counts the FLOPs of the meta dry
    run of the same 1x1 cell."""
    skip_without_card("the cell runs on the card")
    from repro_torch.analysis.account import account
    from repro_torch.kernels.ssd_scan import k2_variant
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_mesh
    kw = dict(global_batch=batch, overrides=overrides)
    cell = build_cell(arch, shape, make_mesh((1, 1), ("data", "model"), "cuda"),
                      device="cuda", seed=0, **kw)
    torch.cuda.synchronize()
    s = cell.lm.cfg.ssm
    want = {k: {(k2_variant(torch.bfloat16, s.head_dim, s.d_state) if v == "k2" else v): n
                for v, n in want.get(k, {}).items()} for k in ("K1", "K2")}
    launches = Launches()
    out = cell.run()
    torch.cuda.synchronize()
    by_variant = launches.by_variant()
    assert {k: {v: n for v, n in by_variant[k].items() if n} for k in want} == want
    logits = out["logits"] if cell.kind == "prefill" else out[0]
    assert tuple(logits.shape[:2]) == (cell.shape.global_batch, 1)
    assert torch.isfinite(logits.float()).all()
    del out, logits
    _, acct = account(cell.run)
    torch.cuda.synchronize()
    del cell
    gc.collect()
    meta = build_cell(arch, shape, make_mesh((1, 1), ("data", "model"), "meta"), device="meta",
                      **kw)
    _, meta_acct = account(meta.run)
    assert acct.flops > 0 and acct.flops == meta_acct.flops


# ---------------------------------------------------------------------- K4
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "granite-4.0-h-small"])
def test_a_reduced_prefill_takes_k4_per_mamba_layer(arch, monkeypatch):
    """A reduced bf16 prefill (batch 4, 1,000 positions: runs of rows cut
    ragged) launches K4 once per Mamba-2 layer (x, B and C in one launch)
    and every ``conv`` span notes ``impl="k4"``; its logits are held to the
    plain route's (``k4_refusal`` forced) by the measures of flash against
    dot."""
    skip_without_card("K4 is CUDA C++ with no CPU mode")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import scope
    from repro_torch.models import ssm
    from repro_torch.models.lm import LM
    cfg = get_config(arch).reduced()
    n_mamba = sum(not (cfg.hybrid and cfg.is_attn_layer(i)) for i in range(cfg.num_layers))
    lm = LM(cfg, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 1_000), generator=g, device="cuda")
    launches = Launches()
    scope.clear()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
        k4 = lm.forward(prompts, mode="prefill")["logits"][..., :cfg.vocab_size].float()
    spans = scope.spans()
    scope.clear()
    assert launches.total()["K4"] == n_mamba
    conv = [sp.attrs for sp in spans if sp.tag == "conv"]
    assert conv == [{"impl": "k4"}] * n_mamba
    monkeypatch.setattr(ssm, "k4_refusal", lambda parts: "forced")
    with torch.inference_mode():
        plain = lm.forward(prompts, mode="prefill")["logits"][..., :cfg.vocab_size].float()
    assert launches.total()["K4"] == n_mamba
    assert torch.isfinite(k4).all()
    _assert_logits_close(k4, plain)
