"""The port's models under autograd: K2's ``SSDScanFn``, the K1 guard,
remat, and one train step of every architecture.

* ``SSDScanFn``'s backward (the plain chunked scan, differentiated) against
  finite differences of its forward with ``torch.autograd.gradcheck`` in
  float64 at a tiny ragged shape, every input and the initial state
  included.  The CPU has no K2: its launch is replaced by the plain
  version, at another chunk length than the backward's, so the check also
  sees that the gradient does not depend on how the forward tiled the
  sequence (K2 tiles by 64 rows, the backward by the model's chunk).
* A bare K2 launch and K1 refuse inputs that require grad while grad is
  enabled, since their outputs would carry no gradient; so does a train
  forward with ``attention_impl="flash"``.
* remat "none", "dots" and "full" give the same loss and gradients, bit
  for bit (the CPU recomputes the same float operations in the same order);
  "dots" and "full" checkpoint each layer (hybrid group, encoder layer)
  once per microbatch, and only "dots" saves some products.
* every architecture of ``ARCH_IDS`` at ``reduced()`` takes one step with a
  finite loss, and every layer's slice of every leaf gets a nonzero
  gradient.  (Within a MoE leaf, an expert that no token of the batch chose
  gets none: 32 tokens pick 2 of 8 experts.)
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.all_configs import ARCH_IDS  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_hmajor  # noqa: E402
from repro_torch.models.convert import jax_layout  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticDataset, batch_to_device  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_step import (init_train_state, loss_and_grads,  # noqa: E402
                                          make_train_step)
from repro_torch.train.tree import items  # noqa: E402


def _ssd_inputs(B=1, H=4, G=2, S=7, P=3, N=2, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=dtype)  # noqa: E731
    x, Bm, Cm = r(B, H, S, P), r(B, G, S, N), r(B, G, S, N)
    dt = torch.nn.functional.softplus(r(B, H, S) - 1.0)
    A = -torch.exp(r(H) * 0.5)
    h0 = r(B, H, P, N) * 0.3
    return [t.requires_grad_(True) for t in (x, dt, A, Bm, Cm, h0)]


def test_ssdscanfn_backward_is_the_gradient_of_the_plain_scan(monkeypatch):
    def plain_launch(x, dt, A, B_in, C_in, h0, variant, y_dtype):
        assert variant == "fma" and y_dtype == x.dtype
        assert not torch.is_grad_enabled()           # Function.forward runs without grad
        return ssd_scan.ssd_scan_hmajor_plain(x, dt, A, B_in, C_in, chunk=3, h0=h0)

    monkeypatch.setattr(ssd_scan, "_launch", plain_launch)
    inputs = _ssd_inputs()
    assert torch.autograd.gradcheck(lambda *a: ssd_scan.SSDScanFn.apply(*a, 4), inputs)
    # without an initial state, and with only x requiring grad
    x, dt, A, Bm, Cm, _ = _ssd_inputs(seed=1)
    assert torch.autograd.gradcheck(
        lambda x_: ssd_scan.SSDScanFn.apply(x_, dt.detach(), A.detach(), Bm.detach(),
                                            Cm.detach(), None, 4), (x,))


def test_ssdscanfn_gives_the_plain_scans_gradient_when_one_output_is_unused(monkeypatch):
    monkeypatch.setattr(ssd_scan, "_launch", lambda x, dt, A, B_in, C_in, h0, *_: (
        ssd_scan.ssd_scan_hmajor_plain(x, dt, A, B_in, C_in, chunk=4, h0=h0)))
    ins = _ssd_inputs(B=2, H=4, G=1, S=9, P=4, N=3, dtype=torch.float32, seed=2)
    y, _ = ssd_scan.SSDScanFn.apply(*ins, 4)            # the state unused, as in a train step
    got = torch.autograd.grad(y.square().sum(), ins)
    y_ref, _ = ssd_scan.ssd_scan_hmajor_plain(*ins[:5], chunk=4, h0=ins[5])
    want = torch.autograd.grad(y_ref.square().sum(), ins)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_the_cpu_takes_the_plain_scan_under_autograd(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("no K2 on the CPU")
    monkeypatch.setattr(ssd_scan.SSDScanFn, "apply", no_kernel)
    ins = _ssd_inputs(dtype=torch.float32)
    y, h = ssd_scan.ssd_scan_hmajor(*ins[:5], chunk=4, h0=ins[5])
    assert y.grad_fn is not None and h.grad_fn is not None


def test_the_plain_scans_gradient_stays_finite_past_the_exp_overflow():
    """A chunk whose decay sums past ~88 (mamba2-1.3b's do at full width)
    overflows exp(cum_i - cum_j) for i < j.  JAX's jnp ``ssd_chunked``
    masks after the exp, so its gradient is NaN there; the port masks the
    exponent first: its float32 gradient is finite and agrees with its
    float64 one, where nothing overflows."""
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
    ins = _ssd_inputs(B=1, H=2, G=1, S=16, P=3, N=2, dtype=torch.float64, seed=3)
    with torch.no_grad():
        ins[1].fill_(8.0)                                 # 16 x 8 = 128 per chunk
    got = torch.autograd.grad(ssd_scan.ssd_scan_hmajor_plain(
        *(t.float() for t in ins[:5]), chunk=16)[0].sum(), ins[:5])
    want = torch.autograd.grad(ssd_scan.ssd_scan_hmajor_plain(*ins[:5], chunk=16)[0].sum(),
                               ins[:5])
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        # float32 keeps cum ~ -128 to ~1e-5, so exp of differences of cums
        # carries ~1e-3 relative error into A's gradient (4.4e-3 here)
        torch.testing.assert_close(a.double(), b, rtol=1e-2, atol=1e-5)
    x, dt, A, Bm, Cm = (np.asarray(t.detach().float().movedim(1, 2).numpy()) if t.dim() > 1
                        else t.detach().float().numpy() for t in ins[:5])
    g = jax.grad(lambda a: jax_ssd_chunked(jnp.asarray(x), jnp.asarray(dt), a, jnp.asarray(Bm),
                                           jnp.asarray(Cm), 16)[0].sum())(jnp.asarray(A))
    assert np.isnan(np.asarray(g)).any()


def test_a_bare_k2_launch_refuses_inputs_that_require_grad():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="SSDScanFn"):
        ssd_scan._launch(x, dt, A, Bm, Cm, None, "fma", torch.float32)
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        ssd_scan._launch(x, dt, A, Bm, Cm, None, "fma", torch.float32)   # valid, on the CPU


def test_k1_refuses_autograd_as_the_pallas_kernel_does():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 8, 16), generator=g) for _ in range(3))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_hmajor(q, k, v)
    with torch.no_grad():
        assert flash_attention_hmajor(q, k, v).shape == q.shape
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), attention_impl="flash")
    lm = LM(cfg, device="cpu", seed=0).requires_grad_(True)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(RuntimeError, match="attention_impl"):
        lm.forward(toks, labels=toks)
    with torch.no_grad():
        assert math.isfinite(float(lm.forward(toks, labels=toks)["loss"]))


def _batch(cfg, seq=16, global_batch=2, accum=1, step=0):
    ds = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                     global_batch=global_batch, accum_steps=accum), cfg)
    return batch_to_device(ds.batch(step), "cpu")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-1.3b", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_remat_none_dots_and_full_give_the_same_gradients(arch, monkeypatch):
    base = get_config(arch).reduced()
    batch = _batch(base, seq=20, global_batch=4, accum=2)
    calls, saved = [], []
    checkpoint, policy = lm_mod.checkpoint, lm_mod._save_unbatched_products

    def counted_checkpoint(fn, *args, **kwargs):
        calls.append(fn)
        return checkpoint(fn, *args, **kwargs)

    def counted_policy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        saved.append(decision == CheckpointPolicy.MUST_SAVE)
        return decision

    monkeypatch.setattr(lm_mod, "checkpoint", counted_checkpoint)
    monkeypatch.setattr(lm_mod, "_save_unbatched_products", counted_policy)
    # layers (hybrid groups, encoder layers) per microbatch, each checkpointed once
    per_mb = (base.num_layers // base.hybrid.attn_period if base.hybrid else base.num_layers) + (
        base.encoder.num_layers if base.encoder else 0)
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=remat, dtype="float32")   # whisper's encoder
        lm = LM(cfg, device="cpu", seed=0).float()
        lm.requires_grad_(True)
        calls.clear()
        saved.clear()
        out[remat] = loss_and_grads(lm, batch, "float32")
        assert len(calls) == (0 if remat == "none" else 2 * per_mb), remat
        assert any(saved) == (remat == "dots") and (remat != "dots" or not all(saved))
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for (key, a), (_, b) in zip(items(out[remat][1]), items(out["none"][1])):
            assert torch.equal(a, b), (remat, key)


def test_unknown_remat_raises():
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(), remat="some")
    lm = LM(cfg, device="cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="remat"):
        lm.forward(torch.zeros((1, 4), dtype=torch.long), labels=torch.zeros((1, 4),
                                                                            dtype=torch.long))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_takes_a_train_step(arch):
    cfg = get_config(arch).reduced()
    lm = LM(cfg, device="cpu", seed=0)
    batch = _batch(cfg)
    loss, grads = loss_and_grads(lm.requires_grad_(True), batch)
    assert math.isfinite(float(loss))
    flat = dict(items(grads))
    for key, (shape, slots) in jax_layout(lm).items():
        assert flat[key].shape == shape and bool(torch.isfinite(flat[key]).all()), key
        for idx, _ in slots:
            assert bool(flat[key][idx].abs().max() > 0), f"{arch}: zero gradient in {key}{idx}"
    ocfg = OptimizerConfig(warmup_steps=0)
    state = init_train_state(lm, ocfg)
    before = {k: v.clone() for k, v in items(state["opt"]["master"])}
    state, m = make_train_step(lm, ocfg)(state, batch)
    assert math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
    assert all(not torch.equal(before[k], v) for k, v in items(state["opt"]["master"]))
