"""Port parity for the SSM slice as a whole: the mamba2 LM and its serve loop.

``get_config("mamba2-1.3b").reduced()`` in both frameworks, with the JAX
parameters carried into the port by ``repro_torch.models.convert``.

* f32 (params cast in both): train and prefill logits and the prefill
  cache (``ssm``, ``conv``) at atol 1e-4, since only the order of float32
  sums differs;
* one decode step from JAX's prefill cache, f32 logits and the new cache
  at atol 1e-4;
* bf16 prefill -> decode consistency at rel < 0.08
  (tests/test_models_smoke.py:93);
* ``repro_torch.launch.serve --arch mamba2-1.3b --reduced --device cpu``.
"""
import functools

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
from repro_torch.launch.serve import grow_cache  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ARCH = "mamba2-1.3b"
B, S = 2, 37          # ragged against the reduced chunk of 16


@pytest.fixture(scope="module")
def jax_model():
    cfg = jax_get_config(ARCH).reduced()
    mesh = single_device_mesh()
    lm = JaxLM(cfg, jax_make_plan(cfg, mesh))
    params = jax.jit(lm.init)(jax.random.PRNGKey(0))     # one compile, not one per leaf
    return cfg, mesh, lm, params


def _port(jax_params, *, f32=False):
    lm = params_from_jax(LM(get_config(ARCH).reduced(), device="cpu", seed=1),
                         jax.tree.map(np.asarray, jax_params))
    return lm.float() if f32 else lm


def _f32(params):
    return jax.tree.map(lambda a: a.astype(jnp.float32), params)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_convert_carries_every_weight_exactly(jax_model):
    _, _, _, params = jax_model
    lm = _port(params)
    assert lm.lm_head is None                      # tied embeddings
    w_x = np.asarray(params["blocks"]["mamba"]["w_x"], np.float32)
    dt_bias = np.asarray(params["blocks"]["mamba"]["dt_bias"], np.float32)
    for i, blk in enumerate(lm.blocks):
        np.testing.assert_array_equal(blk.mamba["w_x"].float().numpy(), w_x[i])
        np.testing.assert_array_equal(blk.mamba["dt_bias"].float().numpy(), dt_bias[i])
    n_port = sum(p.numel() for p in lm.parameters())
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert n_port == n_jax
    bad = jax.tree.map(np.asarray, params)
    bad["blocks"]["mamba"].pop("d_skip")
    with pytest.raises(ValueError, match="blocks.mamba"):
        params_from_jax(LM(get_config(ARCH).reduced(), device="cpu"), bad)


def test_f32_train_prefill_and_decode_match_jax(jax_model):
    cfg, mesh, lm_j, params = jax_model
    p32 = _f32(params)
    lm = _port(params, f32=True)
    toks = _tokens(0, (B, S), cfg.vocab_size)
    nxt = _tokens(1, (B, 1), cfg.vocab_size)
    with mesh:
        train_j = jax.jit(functools.partial(lm_j.forward, mode="train"))(p32, jnp.asarray(toks))
        pf_j = jax.jit(functools.partial(lm_j.forward, mode="prefill"))(p32, jnp.asarray(toks))
        logits_dj, cache_dj = jax.jit(lm_j.decode)(p32, pf_j["cache"], jnp.asarray(nxt), S)
    with torch.no_grad():
        train_t = lm.forward(torch.from_numpy(toks).long(), mode="train")
        pf_t = lm.forward(torch.from_numpy(toks).long(), mode="prefill")
    np.testing.assert_allclose(train_t["logits"].numpy(), np.asarray(train_j["logits"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(pf_t["logits"].numpy(), np.asarray(pf_j["logits"]),
                               atol=1e-4, rtol=0)
    assert set(pf_t["cache"]) == {"ssm", "conv"}
    for name in ("ssm", "conv"):
        assert pf_t["cache"][name].dtype == torch.float32
        np.testing.assert_allclose(pf_t["cache"][name].numpy(),
                                   np.asarray(pf_j["cache"][name]), atol=1e-4, rtol=1e-4)
    # a decode step from JAX's prefill cache, written in place in the port
    cache_t = {n: torch.from_numpy(np.array(x)) for n, x in pf_j["cache"].items()}
    with torch.no_grad():
        logits_dt, new_t = lm.decode(cache_t, torch.from_numpy(nxt).long(), S)
    assert new_t is cache_t
    np.testing.assert_allclose(logits_dt.numpy(), np.asarray(logits_dj), atol=1e-4, rtol=0)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(new_t[name].numpy(), np.asarray(cache_dj[name]),
                                   atol=1e-4, rtol=1e-4)


def test_bf16_prefill_then_decode_matches_forward(jax_model):
    cfg, _, _, params = jax_model
    lm = _port(params)
    toks = torch.from_numpy(_tokens(4, (B, S), cfg.vocab_size)).long()
    nxt = torch.from_numpy(_tokens(5, (B, 1), cfg.vocab_size)).long()
    with torch.no_grad():
        full = lm.forward(torch.cat([toks, nxt], 1), mode="train")["logits"]
        pf = lm.forward(toks, mode="prefill")
        cache = grow_cache(lm.cfg, pf["cache"], 2 * S)
        assert cache is pf["cache"]                # SSM states have no sequence axis
        shapes = {n: x.shape for n, x in cache.items()}
        assert shapes == {n: x.shape for n, x in lm.init_cache(B, 2 * S).items()}
        logits_d, new_cache = lm.decode(cache, nxt, S)
    a = full[:, -1, :cfg.vocab_size].float().numpy()
    b = logits_d[:, 0, :cfg.vocab_size].float().numpy()
    rel = np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-6)
    assert rel < 0.08, f"prefill/decode mismatch rel={rel:.4f}"
    assert {n: x.shape for n, x in new_cache.items()} == shapes


def test_serve_mamba2_on_cpu(capsys):
    from repro_torch.launch import serve
    toks = serve.main(["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "20", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.min() >= 0 and toks.max() < 256
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] arch=mamba2-1.3b")
