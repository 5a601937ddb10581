"""An attention-free Mamba-2 stack: projections, causal convolutions, the
SSD (K2 in prefill, the plain recurrence in decode), a gated norm.

A = -exp(a_log) is drawn uniform in [-16, -1] and softplus(dt_bias)
log-uniform in [1e-3, 1e-1], the published initialisation
(arXiv:2405.21060); the skip weight D about 1.
"""
from __future__ import annotations

import contextlib
import math

import torch

from cardbench.faults import patched
from cardbench.weights import stacked
from cardbench.yardstick import k2_work

FIELDS = {"layer_norm_epsilon": "norm_eps"}
NESTED = {"ssm": {"state_size": "d_state", "head_dim": "head_dim", "expand": "expand",
                  "n_groups": "n_groups", "conv_kernel": "conv_width",
                  "chunk_size": "chunk_size"}}


def _shape(cfg):
    """(d_inner, heads, head size, groups, state size) of a Mamba-2 layer."""
    di = cfg["expand"] * cfg["hidden_size"]
    P = cfg["head_dim"]
    return di, di // P, P, cfg["n_groups"], cfg["state_size"]


def a_log(u):
    """A = -exp(a_log) uniform in [-16, -1]."""
    return torch.log(1.0 + 15.0 * u)


def dt_bias(u):
    """softplus(dt_bias) log-uniform in [1e-3, 1e-1]."""
    dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u)
    return dt + torch.log(-torch.expm1(-dt))


def skip(u):
    """The skip weight D, about 1."""
    return 1.0 + 0.2 * (u - 0.5)


def specs(cfg) -> dict:
    D = cfg["hidden_size"]
    di, nh, _, G, N = _shape(cfg)
    GN, W = G * N, cfg["conv_kernel"]
    return stacked(cfg["num_hidden_layers"], {
        "ln": ((D,), "normal", 0.1),
        "w_z": ((D, di), "normal", D ** -0.5), "w_x": ((D, di), "normal", D ** -0.5),
        "w_B": ((D, GN), "normal", D ** -0.5), "w_C": ((D, GN), "normal", D ** -0.5),
        "w_dt": ((D, nh), "normal", D ** -0.5),
        "dt_bias": ((nh,), dt_bias, None), "a_log": ((nh,), a_log, None),
        "d_skip": ((nh,), skip, None),
        "conv_w": ((W, di), "normal", W ** -0.5), "conv_b": ((di,), "normal", 0.1),
        "conv_wB": ((W, GN), "normal", W ** -0.5), "conv_bB": ((GN,), "normal", 0.1),
        "conv_wC": ((W, GN), "normal", W ** -0.5), "conv_bC": ((GN,), "normal", 0.1),
        "norm": ((di,), "normal", 0.1),
        "w_out": ((di, D), "normal", di ** -0.5)})


def after_draw(cfg, w):
    pass


def param_name(cfg, key, i):
    return f"blocks.{i}.{'' if key == 'ln' else 'mamba.'}{key}"


def projection_params(cfg) -> int:
    D = cfg["hidden_size"]
    di, nh, _, G, N = _shape(cfg)
    return cfg["num_hidden_layers"] * (D * (2 * di + 2 * G * N + nh) + di * D)


def mixer_flops(cfg, seq) -> int:
    """The SSD's chunked products, every layer."""
    _, nh, P, G, N = _shape(cfg)
    return cfg["num_hidden_layers"] * k2_work(1, nh, seq, P, G, N, Q=cfg["chunk_size"])[0]


@contextlib.contextmanager
def state_unchanged():
    """The Mamba-2 step returns the SSM and conv states it was given."""
    from repro_torch.models import ssm
    block = ssm.mamba_block

    def frozen(u, p, cfg, h0=None, conv0=None, decode=False):
        out, states = block(u, p, cfg, h0=h0, conv0=conv0, decode=decode)
        return out, ((h0, conv0) if decode else states)
    with patched(ssm, "mamba_block", frozen):
        yield
