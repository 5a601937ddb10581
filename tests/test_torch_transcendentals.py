"""``cost_analysis["transcendentals"]`` of the port's dry run against XLA's.

The port's account (``analysis.account.transcendentals``) counts the
elements of exp, log, logistic, tanh, rsqrt, sqrt, power, sin, cos and erf
that each dispatched operation computes, every time it runs (K2's exps as
the chunked scan computes them).  XLA's cost analysis counts each while
loop's body once, so the two are compared on reduced cells whose every
loop runs once: one layer, one microbatch, the SSD in one chunk (its
``chunk_size`` at the sequence's 64), on one device.

* Prefill (internlm2, mamba2, phi3.5-moe) and mamba2's decode: equal.
* internlm2's decode: XLA computes RoPE's sin and cos of the one
  position once for the batch's rows (the position is a broadcast
  scalar), the port for each of the B 4 rows: 2 (sin, cos) x 2 (q, k) x
  (B - 1) x head_dim / 2 more.
* Train: XLA reads forward values in the backward that the port's
  autograd computes again: the loss's exps (its gradient is the softmax,
  B x (S-1) x V elements), each silu's logistic (``silu_backward``), and,
  in mamba2, the SSD's exps (the plain scan rerun behind K2, as K2 counts
  them); XLA's softplus backward takes one exp a element that the port's
  does not; and internlm2's RoPE sin and cos are computed again under
  XLA's remat (2 x 2 x S x head_dim / 2 a layer).

At full width JAX's record (internlm2-1.8b train_4k: 8.76e7) counts one
layer of 24 and one microbatch of 8; the port's counts all of them (see
PERF.md's sweep table).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = [("internlm2-1.8b", "prefill_32k"), ("mamba2-1.3b", "prefill_32k"),
         ("phi3.5-moe-42b-a6.6b", "prefill_32k"), ("mamba2-1.3b", "decode_32k"),
         ("internlm2-1.8b", "decode_32k"), ("internlm2-1.8b", "train_4k"),
         ("mamba2-1.3b", "train_4k")]

SCRIPT = r"""
import dataclasses, json, sys
which = sys.argv[1]
out = []
for arch, shape in json.loads(sys.argv[2]):
    if which == "jax":
        from repro.configs import get_config
        from repro.launch.cells import build_cell
        from repro.sharding.plan import single_device_mesh
    else:
        from repro_torch.analysis.account import account
        from repro_torch.configs import get_config
        from repro_torch.launch.cells import build_cell
    cfg = get_config(arch).reduced()
    over = {"num_layers": 1}
    if cfg.ssm is not None:
        over["ssm"] = dataclasses.replace(cfg.ssm, chunk_size=64)
    if which == "jax":
        mesh = single_device_mesh()
        with mesh:
            cell = build_cell(arch, shape, mesh, reduced=True, accum=1, overrides=over)
            ca = cell.lower().compile().cost_analysis()
        out.append((ca[0] if isinstance(ca, list) else ca)["transcendentals"])
    else:
        cell = build_cell(arch, shape, reduced=True, accum=1, overrides=over)
        _, acct = account(cell.run)
        out.append(acct.transcendentals)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = {}
    for which in ("jax", "port"):
        r = subprocess.run([sys.executable, "-c", SCRIPT, which, json.dumps(CELLS)], env=env,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        res[which] = json.loads(r.stdout.strip().splitlines()[-1])
    return {c: (p, j) for c, p, j in zip(CELLS, res["port"], res["jax"])}


@pytest.mark.parametrize("cell", CELLS[:4], ids=lambda c: f"{c[0]}-{c[1]}")
def test_transcendentals_equal_xla_when_every_loop_runs_once(counts, cell):
    port, jax = counts[cell]
    assert port == jax > 0


# reduced dims: B 4 rows of S 64, vocab 256, internlm2 d_ff 128 and
# head_dim 16, mamba2 d_inner 128, G*N 16, 8 heads, the SSD in one chunk
B, S, V = 4, 64, 256
DERIVED = {
    ("internlm2-1.8b", "decode_32k"): 2 * 2 * (B - 1) * 16 // 2,
    ("internlm2-1.8b", "train_4k"): B * (S - 1) * V + B * S * 128 - 2 * 2 * S * 16 // 2,
    ("mamba2-1.3b", "train_4k"): (B * 8 * (S * S + 2 * S + 1)          # the SSD's rerun
                                  + B * S * (2 * 128 + 2 * 16)          # silu backward
                                  + B * (S - 1) * V                     # the loss's exps
                                  - B * S * 8),                         # softplus backward
}


@pytest.mark.parametrize("cell", CELLS[4:], ids=lambda c: f"{c[0]}-{c[1]}")
def test_transcendentals_differ_from_xla_by_what_each_recomputes(counts, cell):
    port, jax = counts[cell]
    assert port - jax == DERIVED[cell], (port, jax)
