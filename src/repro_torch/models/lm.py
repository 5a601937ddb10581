"""The language model, every family: the counterpart of ``repro.models.lm``.

One :class:`LM` module = (ModelConfig, ShardingPlan).  It exposes:

    param_specs() / abstract_params()     per-layer parameter specs / meta tensors
    param_partition_specs()               per-layer PartitionSpec entries
    forward(tokens, ...)                  train / prefill
    cache_struct() / init_cache()         decode caches (KV / SSM / conv)
    decode(cache, token, pos)             one-token serve step

Design notes
------------
* The JAX package scans over stacked layer weights; here the layers are an
  ``nn.ModuleList`` walked by a Python loop.  Weights keep the JAX einsum
  layouts (``wq`` [D,H,hd], ``wo`` [H,hd,D], experts' ``w_gate`` [E,D,F],
  ...), so weights carried across from JAX need no transpose.
* gemma3's local:global pattern is a per-layer ``window`` / ``theta``, plain
  Python numbers here, so every layer can take the flash kernel.
* The decode cache keeps the JAX layout (k/v [L,B,S,K,hd], int8 scales
  [L,B,S,K]) and a decode step writes it in place with ``index_copy_``,
  where JAX returns an updated copy (``dynamic_update_slice`` on a donated
  buffer).
* The SSM family (mamba2) runs one Mamba-2 mixer per layer
  (``models/ssm.py``); its decode cache is ``ssm`` [L,B,H,P,N] and ``conv``
  [L,B,W-1,di+2GN], both float32, which a decode step also writes in place.
* MoE layers (phi3.5-moe, qwen3-moe, Jamba's every other layer) take
  ``models/moe.py``; the aux loss is averaged over layers.
* The hybrid family (Jamba) runs period-``attn_period`` groups: layer
  ``attn_offset`` of a group is attention, the others Mamba-2 mixers, each
  followed by a dense or MoE FFN.  Its cache is ``attn`` k/v [G,B,S,K,hd],
  ``ssm`` [G,per-1,B,H,P,N] and ``conv`` [G,per-1,B,W-1,C].
* The enc-dec family (whisper) runs a non-causal encoder tower over
  ``enc_embeds`` and a cross-attention after each decoder self-attention;
  the cross K/V are computed once at prefill and cached as
  ``{"self": ..., "cross": ...}``.  The vlm family (llava) prepends
  ``embeds_prefix`` to the token embeddings.
* On a plan whose mesh is a DeviceMesh of more than one device, every
  parameter is a DTensor placed from its logical axes (``plan.placements``),
  and so are the caches; the JAX package's leading "layers"/"groups" axis,
  which is never sharded, is the module list here.  DTensor propagates the
  shardings through each operation, as XLA's SPMD partitioner does, and
  ``plan.act`` redistributes where JAX constrains.  Plain tensors that meet
  DTensors (masks, positions) count as replicated.  Built on
  ``device="meta"``, the model draws nothing: its tensors have shapes and
  types and no storage (the dry run).
* Parameters are created with ``requires_grad=False`` (serving);
  ``lm.requires_grad_(True)`` makes them trainable.  A train forward under
  autograd checkpoints each layer (each hybrid group) as ``cfg.remat``
  asks, where JAX rematerialises its scan body: "none" saves every
  activation, "full" only the layer's inputs, and "dots" (JAX's
  ``dots_with_no_batch_dims_saveable``) also the outputs of matrix
  products without batch dimensions (``torch.utils.checkpoint`` with a
  selective-checkpoint policy).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scope import current_scopes
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamSpec, abstract_tree, apply_rope,
                                       cross_entropy_loss, init_tree,
                                       place, rms_norm, spec_tree_partition,
                                       swiglu, torch_dtype, vocab_iota)
from repro_torch.sharding.plan import ShardingPlan, make_plan, per_shard
from repro_torch.train.tree import tree_map


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; asking for an absent card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


# --------------------------------------------------------------------------
# parameter specs (one layer; the JAX package stacks them along [L])
# --------------------------------------------------------------------------
def _ln(D):
    return ParamSpec((D,), ("embed",), init="zeros")


def _attn_specs(cfg: ModelConfig, plan: ShardingPlan,
                cross: bool = False) -> Dict[str, ParamSpec]:
    D, hd = cfg.d_model, cfg.head_dim
    s = {
        "wq": ParamSpec((D, plan.H, hd), ("embed", "q_heads", "head_dim")),
        "wk": ParamSpec((D, plan.K, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, plan.K, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((plan.H, hd, D), ("q_heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = ParamSpec((plan.H, hd), ("q_heads", "head_dim"), init="zeros")
        s["bk"] = ParamSpec((plan.K, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((plan.K, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def _mlp_specs(cfg):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((D, F), ("embed", "mlp")),
        "w_up": ParamSpec((D, F), ("embed", "mlp")),
        "w_down": ParamSpec((F, D), ("mlp", "embed")),
    }


def _moe_specs(cfg):
    D, m = cfg.d_model, cfg.moe
    E, F = m.num_experts, m.d_ff_expert
    return {
        "router": ParamSpec((D, E), ("embed", "experts")),
        "w_gate": ParamSpec((E, D, F), ("experts", "embed", "expert_mlp")),
        "w_up": ParamSpec((E, D, F), ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec((E, F, D), ("experts", "expert_mlp", "embed")),
    }


def _ssm_specs(cfg):
    s, D = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(D), s.n_heads(D)
    GN = s.n_groups * s.d_state
    W = s.conv_width
    return {
        "w_z": ParamSpec((D, di), ("embed", "d_inner")),
        "w_x": ParamSpec((D, di), ("embed", "d_inner")),
        "w_B": ParamSpec((D, GN), ("embed", "state")),
        "w_C": ParamSpec((D, GN), ("embed", "state")),
        "w_dt": ParamSpec((D, nh), ("embed", "ssm_heads")),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="ssm_dt"),
        "a_log": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "conv_w": ParamSpec((W, di), ("conv", "d_inner")),
        "conv_b": ParamSpec((di,), ("d_inner",), init="zeros"),
        "conv_wB": ParamSpec((W, GN), ("conv", "state")),
        "conv_bB": ParamSpec((GN,), ("state",), init="zeros"),
        "conv_wC": ParamSpec((W, GN), ("conv", "state")),
        "conv_bC": ParamSpec((GN,), ("state",), init="zeros"),
        "norm": ParamSpec((di,), ("d_inner",), init="zeros"),
        "w_out": ParamSpec((di, D), ("d_inner", "embed")),
    }


def _quantize_kv(x):
    """x [...,hd] -> (int8, scale[...])."""
    scale = torch.amax(torch.abs(x.float()), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.round(x.float() / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _write_pos(buf, pos: int, val):
    """``buf[:, pos] = val[:, 0]`` in place (dim 1 the sequence).  A DTensor
    cache, which may be sharded on its sequence (the flash-decode layout),
    is written on its local shard by the rank that holds ``pos``; ``val``
    is brought to the cache's placements with its sequence replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(buf, DTensor):
        buf.index_copy_(1, torch.full((1,), pos, dtype=torch.long, device=buf.device), val)
        return
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh, pl = buf.device_mesh, buf.placements
    val_pl = [Replicate() if p.is_shard() and p.dim == 1 else p for p in pl]
    local = val.redistribute(mesh, val_pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh, pl)
    at = pos - offset[1]
    if 0 <= at < shape[1]:
        buf.to_local()[:, at] = local[:, 0]


def _save_unbatched_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matrix products that have no
    batch dimension.  ``x @ w`` reaches the dispatcher as ``mm``, and an
    einsum without batch axes (``bsd,dhk->bshk``) as ``bmm`` with a batch
    of 1; attention scores and the experts' ``bmm`` have a real batch and
    are recomputed, as in JAX.  The experts' batch is theirs even when a
    mesh shard holds one expert (phi3.5-moe's 16 over a model axis of 16):
    the products in the "experts" scope are always recomputed.  K1 and K2
    are ctypes launches that the dispatcher never sees: only the ``empty``
    buffers they fill are ops here, and those are recomputed (and
    refilled) with the rest."""
    if op is torch.ops.aten.mm.default or (op is torch.ops.aten.bmm.default
                                           and args[0].shape[0] == 1
                                           and "experts" not in current_scopes()):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_unbatched_products)


def _direct(fn, *args, **kwargs):
    return fn(*args, **kwargs)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _params(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v) for k, v in tree.items()})


class Block(nn.Module):
    """One decoder or encoder layer: pre-norm attention, then a pre-norm
    SwiGLU (``mlp``) or MoE (``moe``) FFN."""

    def __init__(self, tree):
        super().__init__()
        self.ln1 = _param(tree["ln1"])
        self.ln2 = _param(tree["ln2"])
        self.attn = _params(tree["attn"])
        self.ffn_name = "moe" if "moe" in tree else "mlp"
        setattr(self, self.ffn_name, _params(tree[self.ffn_name]))


class SSMBlock(nn.Module):
    """One Mamba-2 layer: pre-norm mixer with a residual."""

    def __init__(self, tree):
        super().__init__()
        self.ln = _param(tree["ln"])
        self.mamba = _params(tree["mamba"])


class CrossBlock(nn.Module):
    """One decoder layer's cross-attention: pre-norm, K/V from the encoder."""

    def __init__(self, tree):
        super().__init__()
        self.ln = _param(tree["ln"])
        self.attn = _params(tree["attn"])


class HybridGroup(nn.Module):
    """One period of the hybrid stack: per-layer norms ``ln_mix`` /
    ``ln_ffn`` [per, D], one attention, per-1 Mamba-2 mixers, and the dense
    and MoE FFNs in layer order."""

    def __init__(self, tree):
        super().__init__()
        self.ln_mix = _param(tree["ln_mix"])
        self.ln_ffn = _param(tree["ln_ffn"])
        self.attn = _params(tree["attn"])
        for name in ("mamba", "dense_ffn", "moe"):
            setattr(self, name, nn.ModuleList(_params(t) for t in tree[name]))


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, plan: Optional[ShardingPlan] = None, *,
                 device="cuda", seed: int = 0):
        """Builds the model on ``device`` with weights drawn from a
        ``torch.Generator`` seeded with ``seed`` (fan-in normal, as the JAX
        init draws them; the numbers differ from jax.random's).  On
        ``device="meta"`` nothing is drawn.  On a distributed plan each
        weight is drawn whole and then placed (``layers.place``)."""
        super().__init__()
        self.cfg = cfg
        self.plan = plan or make_plan(cfg)
        if cfg.hybrid is not None:
            assert cfg.num_layers % cfg.hybrid.attn_period == 0
            self.n_groups = cfg.num_layers // cfg.hybrid.attn_period
        else:
            self.n_groups = 0
        dev = resolve_device(device)
        specs = self.param_specs()
        if dev.type == "meta":
            tree = tree_map(lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                                                  device=dev), specs)
        else:
            tree = init_tree(torch.Generator(device=dev).manual_seed(seed), specs, dev)
        plan = self.plan
        tree = tree_map(lambda s, t: place(t, plan, plan.spec(*s.logical)), specs, tree)
        self.embed = _param(tree["embed"])
        self.final_norm = _param(tree["final_norm"])
        self.lm_head = None if cfg.tie_embeddings else _param(tree["lm_head"])
        if cfg.family == "hybrid":
            self.groups = nn.ModuleList(HybridGroup(t) for t in tree["groups"])
        else:
            block = SSMBlock if cfg.family == "ssm" else Block
            self.blocks = nn.ModuleList(block(t) for t in tree["blocks"])
        if cfg.encoder is not None:
            self.encoder = nn.ModuleList(Block(t) for t in tree["encoder"])
            self.encoder_norm = _param(tree["encoder_norm"])
            self.cross = nn.ModuleList(CrossBlock(t) for t in tree["cross"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def distributed(self) -> bool:
        return self.plan.info.distributed

    def spmd(self):
        """The context the model runs in: on a distributed plan, plain
        tensors that meet DTensors count as replicated."""
        if not self.distributed:
            return contextlib.nullcontext()
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication
        # implicit_replication() switches the flag off on exit, nested or not:
        # enter it only at the outermost level
        if getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
            return contextlib.nullcontext()
        return implicit_replication()

    # ------------------------------------------------------------- params
    def param_specs(self):
        cfg, plan = self.cfg, self.plan
        D, L = cfg.d_model, cfg.num_layers
        p: Dict[str, Any] = {
            "embed": ParamSpec((plan.V, D), ("vocab", "embed")),
            "final_norm": ParamSpec((D,), ("embed",), init="zeros"),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = ParamSpec((D, plan.V), ("embed", "vocab"))
        if cfg.family == "hybrid":
            per = cfg.hybrid.attn_period
            n_moe = sum(1 for i in range(per) if cfg.is_moe_layer(i))
            norms = ParamSpec((per, D), ("layers", "embed"), init="zeros")
            p["groups"] = [{"ln_mix": norms, "ln_ffn": norms,
                            "attn": _attn_specs(cfg, plan),
                            "mamba": [_ssm_specs(cfg) for _ in range(per - 1)],
                            "dense_ffn": [_mlp_specs(cfg) for _ in range(per - n_moe)],
                            "moe": [_moe_specs(cfg) for _ in range(n_moe)]}
                           for _ in range(self.n_groups)]
        elif cfg.family == "ssm":
            p["blocks"] = [{"ln": _ln(D), "mamba": _ssm_specs(cfg)} for _ in range(L)]
        else:
            ffn = ("moe", _moe_specs) if cfg.moe is not None else ("mlp", _mlp_specs)
            p["blocks"] = [{"ln1": _ln(D), "ln2": _ln(D), "attn": _attn_specs(cfg, plan),
                            ffn[0]: ffn[1](cfg)} for _ in range(L)]
        if cfg.encoder is not None:
            p["encoder"] = [{"ln1": _ln(D), "ln2": _ln(D), "attn": _attn_specs(cfg, plan),
                             "mlp": _mlp_specs(cfg)} for _ in range(cfg.encoder.num_layers)]
            p["encoder_norm"] = ParamSpec((D,), ("embed",), init="zeros")
            p["cross"] = [{"ln": _ln(D), "attn": _attn_specs(cfg, plan, cross=True)}
                          for _ in range(L)]
        return p

    def abstract_params(self):
        """The parameters as meta tensors placed by the plan (no allocation)."""
        return abstract_tree(self.param_specs(), self.plan)

    def param_partition_specs(self):
        return spec_tree_partition(self.param_specs(), self.plan)

    # ------------------------------------------------------------ helpers
    def _layer_window(self, i):
        """(window or None, RoPE theta) of attention layer ``i``."""
        cfg = self.cfg
        if cfg.sliding_window <= 0:
            return None, cfg.rope_theta
        if cfg.is_global_attn_layer(i):
            return -1, cfg.rope_theta
        return cfg.sliding_window, 10_000.0     # gemma3: local layers use 10k rope

    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _attn(self, x, p, *, window, theta, causal=True, cache=None, pos=None,
              cross_kv=None, prefill_kv_dtype=None):
        """Attention sub-layer.  Exactly one cache mode:
          cache+pos        -> decode (write at pos in place, read whole cache)
          prefill_kv_dtype -> prefill (emit a fresh cache of the seq length)
          neither          -> plain training attention
        ``cross_kv`` ({"k", "v"} from the encoder) makes it a cross-attention
        (no RoPE, non-causal, dot).
        Returns (out [B,S,D], new_cache_entry_or_None).
        """
        cfg, plan = self.cfg, self.plan
        B, S, D = x.shape
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        if cross_kv is not None:
            q = plan.act(q, "batch", "seq", "q_heads", "head_dim")
            out = attn_mod.attention(
                q, *self._kv_for_sharded_q(cross_kv["k"], cross_kv["v"]), impl="dot",
                causal=False, window=None, chunk=cfg.attention_chunk)
            return self._sublayer_out(torch.einsum("bshk,hkd->bsd", out, p["wo"])), None

        # no cache to emit: widen the replicated kv weights so that each
        # shard projects only the kv heads its q heads read, then repeat
        # them (locally) for those q heads
        widened = self._kv_replicated() and cache is None and prefill_kv_dtype is None
        wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
        if widened:
            w_rep, k_rep = self._kv_widening()
            wk, wv = (self._widen(w, 1, w_rep, ("embed", "q_heads", "head_dim"))
                      for w in (wk, wv))
            if bk is not None:
                bk, bv = (self._widen(b, 0, w_rep, ("q_heads", "head_dim")) for b in (bk, bv))
        k = torch.einsum("bsd,dhk->bshk", x, wk)
        v = torch.einsum("bsd,dhk->bshk", x, wv)
        if bk is not None:
            k, v = k + bk, v + bv
        heads = "q_heads" if widened else "kv_heads"
        k, v = (plan.act(t, "batch", "seq", heads, "head_dim") for t in (k, v))
        if widened and k_rep > 1:
            k, v = (self._widen(t, 2, k_rep, ("batch", "seq", "q_heads", "head_dim"))
                    for t in (k, v))
        if pos is None:
            positions = torch.arange(S, device=x.device)[None, :]
        else:
            positions = torch.full((B, 1), pos, device=x.device)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
        q = plan.act(q, "batch", "seq", "q_heads", "head_dim")

        new_cache = None
        if cache is not None:
            assert pos is not None
            if "k_scale" in cache:
                kq, ks = _quantize_kv(k)
                vq, vs = _quantize_kv(v)
                for name, val in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
                    _write_pos(cache[name], pos, val)
                k_scale, v_scale = cache["k_scale"], cache["v_scale"]
            else:
                _write_pos(cache["k"], pos, k.to(cache["k"].dtype))
                _write_pos(cache["v"], pos, v.to(cache["v"].dtype))
                k_scale = v_scale = None
            new_cache = cache
            if self._kv_replicated():
                # one query row: gather its heads rather than widen the cache
                q = plan.act(q, "batch", "seq", None, "head_dim")
            out = attn_mod.attention(
                q, cache["k"], cache["v"], impl="dot", causal=False,
                window=window, q_offset=pos, kv_valid_len=pos + 1,
                k_scale=k_scale, v_scale=v_scale, chunk=cfg.attention_chunk)
        else:
            out = attn_mod.attention(
                q, *((k, v) if widened else self._kv_for_sharded_q(k, v)),
                impl=cfg.attention_impl, causal=causal,
                window=window, chunk=cfg.attention_chunk)
            if prefill_kv_dtype is not None:
                if prefill_kv_dtype == "int8":
                    kq, ks = _quantize_kv(k)
                    vq, vs = _quantize_kv(v)
                    new_cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
                else:
                    dt = torch_dtype(prefill_kv_dtype)
                    new_cache = {"k": k.to(dt), "v": v.to(dt)}
        out = plan.act(out, "batch", "seq", "q_heads", "head_dim")
        return self._sublayer_out(torch.einsum("bshk,hkd->bsd", out, p["wo"])), new_cache

    def _sublayer_out(self, h):
        """A sub-layer's output back at (batch, seq, embed): on a mesh the
        partial sums over the model axis are all-reduced here, where XLA's
        partitioner places the all-reduce of a Megatron layer on its own
        (DTensor left alone would rather gather the next layer's weights)."""
        return self.plan.act(h, "batch", "seq", "embed")

    def _kv_replicated(self) -> bool:
        """Are the q heads sharded over the model axis while the kv heads
        are replicated (``plan.kv_sharded`` False), with GQA groups?"""
        plan = self.plan
        return (self.distributed and plan.info.model_size > 1 and not plan.kv_sharded
                and plan.H != plan.K)

    def _kv_for_sharded_q(self, k, v):
        """k, v for an attention whose q heads the model axis shards: when
        the kv heads are replicated, each kv head is repeated for the q heads
        of its group and the result sharded like q, so that every shard's q
        heads meet their own kv heads (the same numbers as GQA; XLA's
        partitioner splits the grouped product the same way)."""
        if not self._kv_replicated():
            return k, v
        G = self.plan.H // self.plan.K
        return tuple(self._widen(t, 2, G, ("batch", "seq", "q_heads", "head_dim"))
                     for t in (k, v))

    def _kv_widening(self):
        """(weight repeat, activation repeat) of the widened kv projection:
        a shard holding q heads of one GQA group projects that group's kv
        head once (weights repeated to one head per shard) and repeats it
        for its q heads, as XLA's partitioner splits the product; otherwise
        every q head gets its own copy."""
        plan = self.plan
        G, per_shard_q = plan.H // plan.K, plan.H // plan.info.model_size
        if G % per_shard_q == 0:
            return G // per_shard_q, per_shard_q
        return G, 1

    def _widen(self, t, dim, n, logical):
        """``t`` with each of its heads (at ``dim``) repeated ``n`` times in
        place, placed by ``logical``.  The repeat runs on each shard's local
        tensor (DTensor need not propagate it): a whole dim repeats whole,
        and a dim cut over the mesh repeats within each shard, which is the
        same order."""
        t = per_shard(lambda loc: torch.repeat_interleave(loc, n, dim=dim),
                      (t.placements,), t.placements)(t)
        # DTensor's own redistribute: the gradient goes back as t was placed
        return t.redistribute(t.device_mesh, self.plan.placements(*logical))

    def _ffn(self, x, p, is_moe: bool):
        """A MoE FFN or a dense SwiGLU with params ``p``; returns (y,
        aux_loss), the aux loss 0 for a dense FFN."""
        if is_moe:
            return moe_mod.moe_ffn(x, p, self.cfg.moe, self.plan, impl=self.cfg.moe_impl,
                                   gather_mode=self.cfg.moe_gather)
        y = swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
        return self._sublayer_out(y), torch.zeros((), device=x.device)

    def _layer_call(self, train: bool):
        """How a stack calls one layer (or hybrid group): through
        ``torch.utils.checkpoint`` with ``cfg.remat``'s policy when it runs
        the train forward under autograd, else directly."""
        remat = self.cfg.remat
        if remat not in ("none", "dots", "full"):
            raise ValueError(f"unknown remat {remat!r}: want none, dots or full")
        if not train or remat == "none" or not torch.is_grad_enabled():
            return _direct
        extra = {"context_fn": _dots_contexts} if remat == "dots" else {}
        return lambda fn, *args, **kwargs: checkpoint(fn, *args, use_reentrant=False,
                                                      **extra, **kwargs)

    # ------------------------------------------------------------ forward
    def forward(self, tokens, *, embeds_prefix=None, enc_embeds=None, labels=None,
                mode="train", kv_dtype="bfloat16"):
        """mode 'train': returns {'loss', 'aux_loss'} (labels given) or
        {'logits', 'aux_loss'}.  mode 'prefill': returns {'logits' [B,1,V],
        'cache'} with the cache at the prompt's length.  The enc-dec family
        needs ``enc_embeds`` [B, source_len, D]; ``embeds_prefix`` [B, n, D]
        goes before the token embeddings (vlm)."""
        if mode not in ("train", "prefill"):
            raise ValueError(f"unknown mode {mode!r}")
        with self.spmd():
            return self._forward(tokens, embeds_prefix=embeds_prefix, enc_embeds=enc_embeds,
                                 labels=labels, mode=mode, kv_dtype=kv_dtype)

    def _forward(self, tokens, *, embeds_prefix, enc_embeds, labels, mode, kv_dtype):
        cfg = self.cfg
        x = self._embed_inputs(tokens, embeds_prefix)
        enc_out = None
        if cfg.encoder is not None:
            if enc_embeds is None:
                raise ValueError(f"{cfg.name}: the enc-dec family needs enc_embeds")
            enc_out = self._encoder(enc_embeds)
        x, new_cache, aux = self._stack(
            x, enc_out=enc_out, prefill_kv_dtype=kv_dtype if mode == "prefill" else None)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        head = self._head()

        if mode == "prefill":
            logits = torch.einsum("bsd,dv->bsv", x[:, -1:], head)
            return {"logits": self._mask_vocab(logits), "cache": new_cache}

        logits = torch.einsum("bsd,dv->bsv", x, head)
        out = {"aux_loss": aux}
        if labels is not None:
            n_img = x.shape[1] - tokens.shape[1]
            if n_img > 0:
                logits = logits[:, n_img:]
            out["loss"] = cross_entropy_loss(logits[:, :-1], labels[:, 1:],
                                             cfg.vocab_size) + 0.01 * aux
        else:
            out["logits"] = self._mask_vocab(logits)
        return out

    def _mask_vocab(self, logits):
        v_real = self.cfg.vocab_size
        if logits.shape[-1] == v_real:
            return logits
        return logits.masked_fill(vocab_iota(logits) >= v_real, -1e30)

    def _embed_inputs(self, tokens, embeds_prefix=None):
        x = F.embedding(tokens, self.embed)
        x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        if embeds_prefix is not None:
            x = torch.cat([embeds_prefix.to(x.dtype), x], dim=1)
        return self.plan.act(x, "batch", "seq", "embed")

    def _encoder(self, enc_embeds):
        """The non-causal encoder tower over frames cast to ``cfg.dtype``."""
        cfg = self.cfg
        x = enc_embeds.to(torch_dtype(cfg.dtype))
        call = self._layer_call(train=True)

        def layer(x, blk):
            h, _ = self._attn(rms_norm(x, blk.ln1, cfg.norm_eps), blk.attn,
                              window=None, theta=cfg.rope_theta, causal=False)
            x = x + h
            m = blk.mlp
            return x + self._sublayer_out(swiglu(rms_norm(x, blk.ln2, cfg.norm_eps),
                                                 m["w_gate"], m["w_up"], m["w_down"]))

        for blk in self.encoder:
            x = call(layer, x, blk)
        return rms_norm(x, self.encoder_norm, cfg.norm_eps)

    # ------------------------------------------------------- layer stacks
    def _stack(self, x, cache=None, enc_out=None, pos=None, prefill_kv_dtype=None):
        """Returns (x, cache, aux_loss)."""
        family = self.cfg.family
        if family == "hybrid":
            return self._stack_hybrid(x, cache=cache, pos=pos,
                                      prefill_kv_dtype=prefill_kv_dtype)
        if family == "ssm":
            return self._stack_ssm(x, cache=cache, pos=pos,
                                   want_cache=prefill_kv_dtype is not None)
        return self._stack_attn(x, cache=cache, enc_out=enc_out, pos=pos,
                                prefill_kv_dtype=prefill_kv_dtype)

    def _stack_ssm(self, x, cache=None, pos=None, want_cache=False):
        """Mamba-2 layers.  Prefill starts each layer's SSD at a zero state
        and, with ``want_cache``, emits the final states; decode (``pos``
        given) steps from ``cache`` and writes the new states into it."""
        cfg = self.cfg
        decode = pos is not None
        aux = torch.zeros((), device=x.device)
        new_layers = []
        call = self._layer_call(train=not decode and not want_cache)

        def layer(x, blk, h0, conv0):
            h, states = ssm_mod.mamba_block(rms_norm(x, blk.ln, cfg.norm_eps), blk.mamba,
                                            cfg, h0=h0, conv0=conv0, decode=decode)
            return x + self._sublayer_out(h), states

        for i, blk in enumerate(self.blocks):
            h0 = conv0 = None
            if decode:
                h0, conv0 = cache["ssm"][i], cache["conv"][i]
            x, (h_new, conv_new) = call(layer, x, blk, h0, conv0)
            if decode:
                cache["ssm"][i].copy_(h_new)
                cache["conv"][i].copy_(conv_new)
            elif want_cache:
                new_layers.append((h_new, conv_new))
        if decode:
            return x, cache, aux
        if not want_cache:
            return x, None, aux
        return x, {"ssm": torch.stack([h for h, _ in new_layers]),
                   "conv": torch.stack([c for _, c in new_layers])}, aux

    def _layer(self, i, x, *, cache=None, pos=None, enc_out=None, cross_cache=None,
               prefill_kv_dtype=None):
        """Layer ``i`` of the attention stack: self-attention, the
        cross-attention of the enc-dec family (K/V from ``cross_cache`` in
        decode, else from ``enc_out``), then the FFN.  Returns (x, self
        cache entry, cross K/V to cache or None, aux loss)."""
        cfg, plan = self.cfg, self.plan
        blk = self.blocks[i]
        window, theta = self._layer_window(i)
        h, new_c = self._attn(
            rms_norm(x, blk.ln1, cfg.norm_eps), blk.attn, window=window, theta=theta,
            cache=cache, pos=pos, prefill_kv_dtype=prefill_kv_dtype)
        x = x + h
        new_cross = None
        if cfg.encoder is not None:
            cp = self.cross[i]
            if pos is not None:
                kv = new_cross = cross_cache
            else:
                kv = {"k": torch.einsum("bsd,dhk->bshk", enc_out, cp.attn["wk"]),
                      "v": torch.einsum("bsd,dhk->bshk", enc_out, cp.attn["wv"])}
                new_cross = kv if prefill_kv_dtype is not None else None
            h, _ = self._attn(rms_norm(x, cp.ln, cfg.norm_eps), cp.attn, window=None,
                              theta=cfg.rope_theta, cross_kv=kv)
            x = x + h
        y, aux = self._ffn(rms_norm(x, blk.ln2, cfg.norm_eps), getattr(blk, blk.ffn_name),
                           is_moe=blk.ffn_name == "moe")
        return plan.act(x + y, "batch", "seq", "embed"), new_c, new_cross, aux

    def _stack_attn(self, x, cache=None, enc_out=None, pos=None, prefill_kv_dtype=None):
        is_encdec = self.cfg.encoder is not None
        self_cache, cross_cache = cache, None
        if is_encdec and pos is not None:
            self_cache, cross_cache = cache["self"], cache["cross"]
        new_self, new_cross, auxes = [], [], []
        call = self._layer_call(train=cache is None and prefill_kv_dtype is None)
        for i in range(len(self.blocks)):
            layer_cache = (None if self_cache is None else
                           {name: t[i] for name, t in self_cache.items()})
            layer_cross = (None if cross_cache is None else
                           {name: t[i] for name, t in cross_cache.items()})
            x, new_c, new_x, aux = call(
                self._layer, i, x, cache=layer_cache, pos=pos, enc_out=enc_out,
                cross_cache=layer_cross, prefill_kv_dtype=prefill_kv_dtype)
            new_self.append(new_c)
            new_cross.append(new_x)
            auxes.append(aux)
        aux = torch.stack(auxes).mean()
        if cache is not None:
            return x, cache, aux
        if prefill_kv_dtype is None:
            return x, None, aux
        stacked = {name: torch.stack([c[name] for c in new_self]) for name in new_self[0]}
        if is_encdec:
            stacked = {"self": stacked, "cross": {
                name: torch.stack([c[name] for c in new_cross]) for name in ("k", "v")}}
        return x, stacked, aux

    def _stack_hybrid(self, x, cache=None, pos=None, prefill_kv_dtype=None):
        """Period groups of one attention and per-1 Mamba-2 layers, each
        followed by a dense or MoE FFN.  Decode writes the group's KV, SSM
        and conv states into ``cache`` in place; prefill with
        ``prefill_kv_dtype`` emits them."""
        decode = pos is not None
        call = self._layer_call(train=not decode and prefill_kv_dtype is None)
        auxes, new_groups = [], []
        for g in range(len(self.groups)):
            x, aux, states = call(self._group, g, x, cache=cache, pos=pos,
                                  prefill_kv_dtype=prefill_kv_dtype)
            auxes.append(aux)
            new_groups.append(states)
        aux = torch.stack(auxes).mean()
        if decode:
            return x, cache, aux
        if prefill_kv_dtype is None:
            return x, None, aux
        return x, {"attn": {name: torch.stack([a[name] for a, _, _ in new_groups])
                            for name in new_groups[0][0]},
                   "ssm": torch.stack([torch.stack(s) for _, s, _ in new_groups]),
                   "conv": torch.stack([torch.stack(c) for _, _, c in new_groups])}, aux

    def _group(self, g, x, *, cache=None, pos=None, prefill_kv_dtype=None):
        """Group ``g`` of the hybrid stack.  Returns (x, the group's aux loss
        over its period, (attention cache entry, SSM states, conv states))."""
        cfg = self.cfg
        grp = self.groups[g]
        per = cfg.hybrid.attn_period
        decode = pos is not None
        aux_total = torch.zeros((), device=x.device)
        attn_c, states, convs = None, [], []
        mamba_i = moe_i = dense_i = 0
        for i in range(per):
            xin = rms_norm(x, grp.ln_mix[i], cfg.norm_eps)
            if cfg.is_attn_layer(i):
                layer_cache = ({name: t[g] for name, t in cache["attn"].items()}
                               if decode else None)
                h, attn_c = self._attn(xin, grp.attn, window=None, theta=cfg.rope_theta,
                                       cache=layer_cache, pos=pos,
                                       prefill_kv_dtype=prefill_kv_dtype)
            else:
                h0 = conv0 = None
                if decode:
                    h0, conv0 = cache["ssm"][g, mamba_i], cache["conv"][g, mamba_i]
                h, (h_new, conv_new) = ssm_mod.mamba_block(
                    xin, grp.mamba[mamba_i], cfg, h0=h0, conv0=conv0, decode=decode)
                if decode:
                    cache["ssm"][g, mamba_i].copy_(h_new)
                    cache["conv"][g, mamba_i].copy_(conv_new)
                states.append(h_new)
                convs.append(conv_new)
                mamba_i += 1
            x = x + self._sublayer_out(h)
            xf = rms_norm(x, grp.ln_ffn[i], cfg.norm_eps)
            if cfg.is_moe_layer(i):
                y, aux = self._ffn(xf, grp.moe[moe_i], is_moe=True)
                aux_total = aux_total + aux
                moe_i += 1
            else:
                y, _ = self._ffn(xf, grp.dense_ffn[dense_i], is_moe=False)
                dense_i += 1
            x = self.plan.act(x + y, "batch", "seq", "embed")
        return x, aux_total / per, (attn_c, states, convs)

    # -------------------------------------------------------------- decode
    def decode(self, cache, token, pos: int):
        """One serve step.  token [B,1] int; pos int (the image prefix
        counted).  Writes the new key and value (or the new SSM and conv
        states) into ``cache`` in place.  Returns (logits [B,1,V_pad] with
        the padded vocab masked, cache)."""
        with self.spmd():
            x = self._embed_inputs(token)
            x, cache, _ = self._stack(x, cache=cache, pos=pos)
            x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
            logits = torch.einsum("bsd,dv->bsv", x, self._head())
            return self._mask_vocab(logits), cache

    # ----------------------------------------------------------- caches
    def cache_layout(self, batch: int, seq: int, kv_dtype: str = "bfloat16"):
        """The decode cache as a nest of (shape, dtype name, PartitionSpec
        entries), in the JAX layout and with the JAX specs."""
        cfg, plan = self.cfg, self.plan

        def kv_layers(lead, S, dtype, full):
            n = len(lead)
            shape = (*lead, batch, S, plan.K, cfg.head_dim)
            kspec = (None,) * n + full[2:]
            c = {"k": (shape, dtype, kspec), "v": (shape, dtype, kspec)}
            if dtype == "int8":
                sspec = (None,) * n + full[2:-1]
                c["k_scale"] = (shape[:-1], "float32", sspec)
                c["v_scale"] = (shape[:-1], "float32", sspec)
            return c

        def ssm_layers(lead):
            s = cfg.ssm
            n = len(lead)
            di, GN = s.d_inner(cfg.d_model), s.n_groups * s.d_state
            return {"ssm": ((*lead, batch, s.n_heads(cfg.d_model), s.head_dim, s.d_state),
                            "float32", (None,) * n + plan.ssm_cache_spec(batch)[1:]),
                    "conv": ((*lead, batch, s.conv_width - 1, di + 2 * GN), "float32",
                             (None,) * n + plan.conv_cache_spec(batch)[1:])}

        full = plan.kv_cache_spec(batch)              # [L,2,B,S,K,hd]
        if cfg.family == "ssm":
            return ssm_layers((cfg.num_layers,))
        if cfg.family == "hybrid":
            return {"attn": kv_layers((self.n_groups,), seq, kv_dtype, full),
                    **ssm_layers((self.n_groups, cfg.hybrid.attn_period - 1))}
        c = kv_layers((cfg.num_layers,), seq, kv_dtype, full)
        if cfg.encoder is not None:
            return {"self": c, "cross": kv_layers((cfg.num_layers,), cfg.encoder.source_len,
                                                  cfg.dtype, (None,) + full[1:])}
        return c

    def _make_cache(self, make, batch, seq, kv_dtype):
        def build(node):
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            shape, dtype, spec = node
            return place(make(shape, torch_dtype(dtype)), self.plan, spec)
        return build(self.cache_layout(batch, seq, kv_dtype))

    def cache_struct(self, batch: int, seq: int, kv_dtype: str = "bfloat16"):
        """The decode cache as meta tensors placed by the plan (no allocation)."""
        return self._make_cache(lambda shape, dt: torch.empty(shape, dtype=dt, device="meta"),
                                batch, seq, kv_dtype)

    def init_cache(self, batch: int, seq: int, kv_dtype: str = "bfloat16"):
        """A zero decode cache on the model's device (placed by the plan)."""
        dev = self.device
        return self._make_cache(lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev),
                                batch, seq, kv_dtype)

