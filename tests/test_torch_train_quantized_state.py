"""Port parity for ``repro_torch.train.quantized_state``: block-wise int8
optimizer state.

The cases of tests/test_quantized_state.py on the port: the round-trip
bound, shape and ``n_blocks``, the int8 state being smaller, and AdamW
with int8 state on a quadratic and against the fp32 trajectory.  (The JAX
package marks them ``slow`` for their compiles; here they take well under
a second.)  Then ``q8_encode`` and ``q8_decode`` against JAX's on shared
NumPy inputs, bit for bit, ragged last blocks included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.train import quantized_state as jax_q  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.quantized_state import (BLOCK, n_blocks, q8_decode,  # noqa: E402
                                               q8_encode, state_bytes)


def _randn(seed, shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * scale)
                            .astype(np.float32))


def test_q8_roundtrip_error_bound():
    x = _randn(0, (1000,), 3.0)
    q, s = q8_encode(x)
    y = q8_decode(q, s)
    # block absmax quantization: error <= scale/2 per element
    blocks = torch.nn.functional.pad(x, (0, 24)).reshape(-1, BLOCK)
    bound = blocks.abs().amax(dim=-1) / 127.0
    per_block = torch.nn.functional.pad((y - x).abs(), (0, 24)).reshape(-1, BLOCK)
    assert float((per_block - bound[:, None] / 2 - 1e-6).max()) <= 0


def test_q8_preserves_shape_and_nblocks():
    x = _randn(1, (3, 5, 7))
    q, s = q8_encode(x)
    assert q.shape == x.shape and q.dtype == torch.int8
    assert s.shape == (n_blocks(x.shape),) and s.dtype == torch.float32
    np.testing.assert_allclose(q8_decode(q, s).numpy(), x.numpy(),
                               atol=float(x.abs().max()) / 100)


def test_adamw_int8_state_minimizes_quadratic():
    cfg = opt.OptimizerConfig(learning_rate=0.1, warmup_steps=0, weight_decay=0.0,
                              clip_norm=0.0, state_bits=8)
    params = {"w": torch.tensor([5.0, -3.0, 2.0, -1.0])}
    state = opt.init_opt_state(params, cfg)
    assert isinstance(state["m"]["w"], dict)            # quantized
    for _ in range(150):
        params, state, _ = opt.apply_updates(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_int8_state_is_smaller():
    params = {"w": torch.zeros((1024, 1024), dtype=torch.bfloat16)}
    s32 = opt.init_opt_state(params, opt.OptimizerConfig(state_bits=32, use_master=False))
    s8 = opt.init_opt_state(params, opt.OptimizerConfig(state_bits=8, use_master=False))
    b32 = state_bytes({"m": s32["m"], "v": s32["v"]})
    b8 = state_bytes({"m": s8["m"], "v": s8["v"]})
    assert b8 < b32 / 3.8                               # ~2.03 vs 8 B/param


def test_int8_matches_fp32_trajectory_approximately():
    w0, target = _randn(2, (512,)), _randn(3, (512,))

    def run(bits):
        cfg = opt.OptimizerConfig(learning_rate=0.05, warmup_steps=0, weight_decay=0.0,
                                  clip_norm=0.0, state_bits=bits)
        params = {"w": w0}
        state = opt.init_opt_state(params, cfg)
        for _ in range(100):
            params, state, _ = opt.apply_updates(
                params, {"w": 2 * (params["w"] - target)}, state, cfg)
        return params["w"]

    w32, w8 = run(32), run(8)
    # the int8 trajectory tracks the fp32 one closely and is no worse
    assert float((w8 - w32).abs().mean()) < 0.05
    err32, err8 = float((w32 - target).abs().max()), float((w8 - target).abs().max())
    assert err8 < err32 + 0.1
    assert err8 < float((w0 - target).abs().max()) / 2


@pytest.mark.parametrize("shape", [(1000,), (3, 5, 7), (256,), (2, 256), (4, 300), (1,),
                                   (64, 48)])
def test_q8_encode_and_decode_equal_jax_bit_for_bit(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 3
    x.reshape(-1)[::37] = 0.0                          # zeros and a half-step tie or two
    q, s = q8_encode(torch.from_numpy(x))
    qj, sj = jax_q.q8_encode(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(q8_decode(q, s).numpy(),
                                  np.asarray(jax_q.q8_decode(qj, sj)))
    assert n_blocks(shape) == jax_q.n_blocks(shape)


def test_q8_rounds_half_to_even_as_jax():
    """Entries at exactly k + 1/2 of a scale step: both round to even."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    q, _ = q8_encode(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), [127, 0, 2, 2, 0, -2, -2, 4])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jax_q.q8_encode(jnp.asarray(x))[0]))
