"""The port's per-device FLOPs against the JAX package's, where the two
count different work for a reason that is no missing work.

The dry run (``launch/dryrun.py``) counts, per device, the FLOPs of the
products the port dispatches; JAX's counts the dot ops of its
SPMD-partitioned HLO.  Most cells count the same products.  Four kinds of
difference do not, and each function here gives the difference, port minus JAX,
from the configuration and the mesh alone:

``ssd_serve_delta``
    A prefill runs the SSD through K2, whose work (``kernels.ssd_scan.
    work``) is the chunk block decomposition with the causal half of the
    intra-chunk product and C·Bᵀ over the whole state; XLA's partitioned
    ``ssd_chunked`` computes the whole Q x Q intra-chunk product and C·Bᵀ
    over the state cut on the model axis (then all-reduced).

``ssd_train_delta``
    A train step runs K2 forward (twice under remat "full", whose
    recompute runs it again; "dots" keeps its outputs); ``SSDScanFn``'s
    backward reruns the plain chunked scan (the forward's intermediates,
    which K2 does not keep) and differentiates it, skipping the products
    whose gradient is zero (the first chunk's zero state, the last chunk's
    unused state update).  XLA counts its forward, the forward again where
    its remat recomputes it ("dots" or "full"; the reduced configs' "none"
    does not) and the transposes (twice the forward).

``fsdp_train_delta``
    Under FSDP the B/C projections' weights are cut over the data axes and
    whole over the model axis; on one pod XLA computes their weight
    gradient split over the model axis, the port (and XLA on two pods)
    whole on every model shard.

``fsdp_decode_delta``
    At batch 1 under FSDP (long_500k, the batch replicated over the data
    axes), DTensor splits a product whose weight has its embed dim cut over
    the data axes (each data shard multiplies its rows and the partial sums
    are all-reduced); XLA gathers the weight and every data shard computes
    the whole product.  Same work, spread over the data shards.  On two
    pods the decode's kv projections also split their contraction over the
    model axis, which XLA does on one pod only.

Every count is per device.  ``mesh`` is the {axis name: size} of the
production mesh.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _ssd_dims(cfg: ModelConfig, shape: ShapeConfig, mesh: dict, batch: int):
    """(b, H, P, N, G, Q, nc, layers, m) of one device's SSD."""
    s = cfg.ssm
    data = mesh.get("pod", 1) * mesh.get("data", 1)
    m = mesh.get("model", 1)
    b = batch // data if batch % data == 0 else batch
    H = s.n_heads(cfg.d_model) // m
    Q = min(s.chunk_size, shape.seq_len)
    nc = -(-shape.seq_len // Q)
    layers = cfg.num_layers
    if cfg.hybrid is not None:
        layers = cfg.num_layers - cfg.num_layers // cfg.hybrid.attn_period
    return b, H, s.head_dim, s.d_state, s.n_groups, Q, nc, layers, m


def _ssd_products(b, H, P, N, G, Q):
    """Per chunk: (C·Bᵀ, the whole intra-chunk product, C·h, the state
    update) of the chunked scan, 2 x M x N x K each."""
    return 2 * b * G * Q * Q * N, 2 * b * H * P * Q * Q, 2 * b * Q * H * P * N, 2 * b * Q * H * P * N


def _k2_chunk(b, H, P, N, G, Q):
    """K2's work per chunk (``kernels.ssd_scan.work``): the causal half of
    the intra-chunk product."""
    cb, _, ch, st = _ssd_products(b, H, P, N, G, Q)
    return cb + b * H * P * Q * (Q + 1) + ch + st


def ssd_serve_delta(cfg: ModelConfig, shape: ShapeConfig, mesh: dict) -> float:
    """Port minus JAX FLOPs of a prefill's SSD (see the module docstring)."""
    if cfg.ssm is None or shape.kind != "prefill":
        return 0.0
    b, H, P, N, G, Q, nc, layers, m = _ssd_dims(cfg, shape, mesh, shape.global_batch)
    cb, y, ch, st = _ssd_products(b, H, P, N, G, Q)
    cut = m if (G * N) % m == 0 else 1                # C·Bᵀ over the state cut
    xla = cb / cut + y + ch + st
    return float(layers * nc * (_k2_chunk(b, H, P, N, G, Q) - xla))


def ssd_train_delta(cfg: ModelConfig, shape: ShapeConfig, mesh: dict, accum: int) -> float:
    """Port minus JAX FLOPs of a train step's SSD over ``accum``
    microbatches (see the module docstring)."""
    if cfg.ssm is None or shape.kind != "train":
        return 0.0
    k2_runs = 2 if cfg.remat == "full" else 1
    xla_forwards = 3 if cfg.remat == "none" else 4
    b, H, P, N, G, Q, nc, layers, m = _ssd_dims(cfg, shape, mesh, shape.global_batch // accum)
    cb, y, ch, st = _ssd_products(b, H, P, N, G, Q)
    fwd = nc * (cb + y + ch + st)
    k2 = nc * _k2_chunk(b, H, P, N, G, Q)
    # the rerun's backward: every product's two operands but the first
    # chunk's state (zeros) and the last chunk's state update (unused)
    bwd = nc * (2 * cb + 2 * y) + (2 * nc - 1) * ch + (2 * nc - 2) * st
    return float(layers * accum * (k2_runs * k2 + fwd + bwd - xla_forwards * fwd))


def fsdp_decode_delta(cfg: ModelConfig, shape: ShapeConfig, mesh: dict, fsdp: bool,
                      kv_replicated: bool) -> float:
    """Port minus JAX FLOPs of a decode step under FSDP (see the module
    docstring): at a batch the data axes do not divide, the products whose
    weights' embed dim the data axes cut; on two pods, with the kv heads
    replicated, the kv projections."""
    data = mesh.get("pod", 1) * mesh.get("data", 1)
    m = mesh.get("model", 1)
    B = shape.global_batch
    if shape.kind != "decode" or not fsdp:
        return 0.0
    D = cfg.d_model
    T = B if B % data else B // data          # tokens per device
    if cfg.hybrid is not None:
        per = cfg.hybrid.attn_period
        groups = cfg.num_layers // per
        n_moe = sum(1 for i in range(per) if cfg.is_moe_layer(i))
        n_attn, n_mamba, n_dense = groups, groups * (per - 1), groups * (per - n_moe)
    else:
        n_attn, n_mamba = cfg.num_layers, 0
        n_dense = 0 if cfg.moe is not None else cfg.num_layers
    delta = 0.0
    if B % data:
        xla = n_attn * 2 * 2 * T * D * cfg.num_heads * cfg.head_dim / m       # q, o
        xla += n_dense * 3 * 2 * T * D * cfg.d_ff / m                         # SwiGLU
        if n_mamba:
            s = cfg.ssm
            di, nh, GN = s.d_inner(D), s.n_heads(D), s.n_groups * s.d_state
            xla += n_mamba * 2 * T * D * (3 * di + 2 * GN + nh) / m          # z, x, out, B, C, dt
        delta -= xla * (1 - 1 / data)
    if "pod" in mesh and kv_replicated:
        delta -= n_attn * 2 * 2 * T * D * cfg.num_kv_heads * cfg.head_dim * (1 - 1 / m)
    return float(delta)


def fsdp_train_delta(cfg: ModelConfig, shape: ShapeConfig, mesh: dict, accum: int,
                     fsdp: bool) -> float:
    """Port minus JAX FLOPs of the B/C projections' weight gradient in a
    train step under FSDP on one pod (see the module docstring): XLA
    splits it over the model axis, the port computes it whole on each
    model shard."""
    if cfg.ssm is None or shape.kind != "train" or not fsdp or "pod" in mesh:
        return 0.0
    b, _, _, N, G, _, _, layers, m = _ssd_dims(cfg, shape, mesh, shape.global_batch // accum)
    T = b * shape.seq_len
    return float(layers * accum * 2 * 2 * T * cfg.d_model * G * N * (1 - 1 / m))


def cell_delta(cfg: ModelConfig, shape: ShapeConfig, plan, accum: int = 1) -> float:
    """Port minus JAX per-device FLOPs of a cell on ``plan``'s mesh: the
    sum of the differences above that apply to it."""
    mesh = plan.info.shape
    kv_replicated = (plan.info.model_size > 1 and not plan.kv_sharded and plan.H != plan.K)
    return (ssd_serve_delta(cfg, shape, mesh)
            + ssd_train_delta(cfg, shape, mesh, accum)
            + fsdp_train_delta(cfg, shape, mesh, accum, plan.fsdp)
            + fsdp_decode_delta(cfg, shape, mesh, plan.fsdp, kv_replicated))
