"""The language model, dense and SSM families: the counterpart of
``repro.models.lm``.

One :class:`LM` module = (ModelConfig, ShardingPlan) on one device.  It
exposes:

    param_specs()                         per-layer parameter specs
    forward(tokens, ...)                  train / prefill
    init_cache()                          decode KV cache
    decode(cache, token, pos)             one-token serve step

Design notes
------------
* The JAX package scans over stacked layer weights; here the layers are an
  ``nn.ModuleList`` walked by a Python loop.  Weights keep the JAX einsum
  layouts (``wq`` [D,H,hd], ``wo`` [H,hd,D], ...), so weights carried across
  from JAX need no transpose.
* gemma3's local:global pattern is a per-layer ``window`` / ``theta``, plain
  Python numbers here, so every layer can take the flash kernel.
* The decode cache keeps the JAX layout (k/v [L,B,S,K,hd], int8 scales
  [L,B,S,K]) and a decode step writes it in place with ``index_copy_``,
  where JAX returns an updated copy (``dynamic_update_slice`` on a donated
  buffer).
* The SSM family (mamba2) runs one Mamba-2 mixer per layer
  (``models/ssm.py``); its decode cache is ``ssm`` [L,B,H,P,N] and ``conv``
  [L,B,W-1,di+2GN], both float32, which a decode step also writes in place.
* Other families (MoE, hybrid, enc-dec, vlm) are not ported yet and raise
  ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamSpec, apply_rope, cross_entropy_loss,
                                       init_tree, rms_norm, swiglu, torch_dtype)
from repro_torch.sharding.plan import ShardingPlan, make_plan

# ROADMAP.md items ("Modules still to port") that bring the other families
_FAMILY_ITEMS = {
    "moe": "MoE (moe.py)",
    "hybrid": "the other families: hybrid",
    "encdec": "the other families: encdec",
    "vlm": "the other families: vlm",
}


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


def _attn_specs(cfg: ModelConfig, plan: ShardingPlan) -> Dict[str, ParamSpec]:
    D, hd = cfg.d_model, cfg.head_dim
    s = {
        "wq": ParamSpec((D, plan.H, hd), ("embed", "q_heads", "head_dim")),
        "wk": ParamSpec((D, plan.K, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, plan.K, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((plan.H, hd, D), ("q_heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
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


def _params(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Block(nn.Module):
    """One decoder layer: pre-norm attention, then pre-norm SwiGLU."""

    def __init__(self, tree):
        super().__init__()
        self.ln1 = nn.Parameter(tree["ln1"], requires_grad=False)
        self.ln2 = nn.Parameter(tree["ln2"], requires_grad=False)
        self.attn = _params(tree["attn"])
        self.mlp = _params(tree["mlp"])


class SSMBlock(nn.Module):
    """One Mamba-2 layer: pre-norm mixer with a residual."""

    def __init__(self, tree):
        super().__init__()
        self.ln = nn.Parameter(tree["ln"], requires_grad=False)
        self.mamba = _params(tree["mamba"])


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, plan: Optional[ShardingPlan] = None, *,
                 device="cuda", seed: int = 0):
        """Builds the model on ``device`` with weights drawn from a
        ``torch.Generator`` seeded with ``seed`` (fan-in normal, as the JAX
        init draws them; the numbers differ from jax.random's)."""
        super().__init__()
        if cfg.family not in ("dense", "ssm") or any(x is not None for x in (
                cfg.moe, cfg.hybrid, cfg.encoder)) or cfg.num_image_tokens:
            fam = cfg.family if cfg.family in _FAMILY_ITEMS else "moe"
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet; ROADMAP.md "
                f"item: {_FAMILY_ITEMS[fam]}")
        self.cfg = cfg
        self.plan = plan or make_plan(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tree = init_tree(gen, self.param_specs(), dev)
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.final_norm = nn.Parameter(tree["final_norm"], requires_grad=False)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Parameter(tree["lm_head"], requires_grad=False))
        block = SSMBlock if cfg.family == "ssm" else Block
        self.blocks = nn.ModuleList(block(t) for t in tree["blocks"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- params
    def param_specs(self):
        cfg, plan = self.cfg, self.plan
        D = cfg.d_model
        p: Dict[str, Any] = {
            "embed": ParamSpec((plan.V, D), ("vocab", "embed")),
            "final_norm": ParamSpec((D,), ("embed",), init="zeros"),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = ParamSpec((D, plan.V), ("embed", "vocab"))
        if cfg.family == "ssm":
            p["blocks"] = [{"ln": _ln(D), "mamba": _ssm_specs(cfg)}
                           for _ in range(cfg.num_layers)]
        else:
            p["blocks"] = [{"ln1": _ln(D), "ln2": _ln(D), "attn": _attn_specs(cfg, plan),
                            "mlp": _mlp_specs(cfg)} for _ in range(cfg.num_layers)]
        return p

    # ------------------------------------------------------------ helpers
    def _layer_windows(self):
        cfg = self.cfg
        win, theta = [], []
        for i in range(cfg.num_layers):
            if cfg.is_global_attn_layer(i):
                win.append(-1)
                theta.append(cfg.rope_theta)
            else:
                win.append(cfg.sliding_window)
                theta.append(10_000.0)   # gemma3: local layers use 10k rope
        return win, theta

    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _attn(self, x, p, *, window, theta, cache=None, pos=None,
              prefill_kv_dtype=None):
        """Attention sub-layer.  Exactly one cache mode:
          cache+pos        -> decode (write at pos in place, read whole cache)
          prefill_kv_dtype -> prefill (emit a fresh cache of the seq length)
          neither          -> plain training attention
        Returns (out [B,S,D], new_cache_entry_or_None).
        """
        cfg, plan = self.cfg, self.plan
        B, S, D = x.shape
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
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
            idx = torch.full((1,), pos, dtype=torch.long, device=x.device)
            if "k_scale" in cache:
                kq, ks = _quantize_kv(k)
                vq, vs = _quantize_kv(v)
                cache["k"].index_copy_(1, idx, kq)
                cache["v"].index_copy_(1, idx, vq)
                cache["k_scale"].index_copy_(1, idx, ks)
                cache["v_scale"].index_copy_(1, idx, vs)
                k_scale, v_scale = cache["k_scale"], cache["v_scale"]
            else:
                cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
                cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
                k_scale = v_scale = None
            new_cache = cache
            out = attn_mod.attention(
                q, cache["k"], cache["v"], impl="dot", causal=False,
                window=window, q_offset=pos, kv_valid_len=pos + 1,
                k_scale=k_scale, v_scale=v_scale, chunk=cfg.attention_chunk)
        else:
            out = attn_mod.attention(
                q, k, v, impl=cfg.attention_impl, causal=True, window=window,
                chunk=cfg.attention_chunk)
            if prefill_kv_dtype is not None:
                if prefill_kv_dtype == "int8":
                    kq, ks = _quantize_kv(k)
                    vq, vs = _quantize_kv(v)
                    new_cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
                else:
                    dt = torch_dtype(prefill_kv_dtype)
                    new_cache = {"k": k.to(dt), "v": v.to(dt)}
        out = plan.act(out, "batch", "seq", "q_heads", "head_dim")
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), new_cache

    # ------------------------------------------------------------ forward
    def forward(self, tokens, *, labels=None, mode="train", kv_dtype="bfloat16"):
        """mode 'train': returns {'loss', 'aux_loss'} (labels given) or
        {'logits', 'aux_loss'}.  mode 'prefill': returns {'logits' [B,1,V],
        'cache'} with the cache at the prompt's length."""
        cfg = self.cfg
        if mode not in ("train", "prefill"):
            raise ValueError(f"unknown mode {mode!r}")
        x = self._embed_inputs(tokens)
        x, new_cache = self._stack(
            x, prefill_kv_dtype=kv_dtype if mode == "prefill" else None)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        head = self._head()

        if mode == "prefill":
            logits = torch.einsum("bsd,dv->bsv", x[:, -1:], head)
            return {"logits": self._mask_vocab(logits), "cache": new_cache}

        logits = torch.einsum("bsd,dv->bsv", x, head)
        out = {"aux_loss": torch.zeros((), device=x.device)}
        if labels is not None:
            out["loss"] = cross_entropy_loss(logits[:, :-1], labels[:, 1:],
                                             cfg.vocab_size) + 0.01 * out["aux_loss"]
        else:
            out["logits"] = self._mask_vocab(logits)
        return out

    def _mask_vocab(self, logits):
        v_real = self.cfg.vocab_size
        if logits.shape[-1] == v_real:
            return logits
        iota = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(iota < v_real, logits, -1e30)

    def _embed_inputs(self, tokens):
        x = self.embed[tokens]
        x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return self.plan.act(x, "batch", "seq", "embed")

    # ------------------------------------------------------- layer stacks
    def _stack(self, x, cache=None, pos=None, prefill_kv_dtype=None):
        if self.cfg.family == "ssm":
            return self._stack_ssm(x, cache=cache, pos=pos,
                                   want_cache=prefill_kv_dtype is not None)
        return self._stack_attn(x, cache=cache, pos=pos,
                                prefill_kv_dtype=prefill_kv_dtype)

    def _stack_ssm(self, x, cache=None, pos=None, want_cache=False):
        """Mamba-2 layers.  Prefill starts each layer's SSD at a zero state
        and, with ``want_cache``, emits the final states; decode (``pos``
        given) steps from ``cache`` and writes the new states into it."""
        cfg = self.cfg
        decode = pos is not None
        new_layers = []
        for i, blk in enumerate(self.blocks):
            h0 = conv0 = None
            if decode:
                h0, conv0 = cache["ssm"][i], cache["conv"][i]
            h, (h_new, conv_new) = ssm_mod.mamba_block(
                rms_norm(x, blk.ln, cfg.norm_eps), blk.mamba, cfg, h0=h0,
                conv0=conv0, decode=decode)
            x = x + h
            if decode:
                cache["ssm"][i].copy_(h_new)
                cache["conv"][i].copy_(conv_new)
            elif want_cache:
                new_layers.append((h_new, conv_new))
        if decode:
            return x, cache
        if not want_cache:
            return x, None
        return x, {"ssm": torch.stack([h for h, _ in new_layers]),
                   "conv": torch.stack([c for _, c in new_layers])}

    def _stack_attn(self, x, cache=None, pos=None, prefill_kv_dtype=None):
        cfg, plan = self.cfg, self.plan
        win, theta = self._layer_windows()
        new_layers = []
        for i, blk in enumerate(self.blocks):
            w_i = win[i] if cfg.sliding_window > 0 else None
            layer_cache = (None if cache is None else
                           {name: t[i] for name, t in cache.items()})
            h, new_c = self._attn(
                rms_norm(x, blk.ln1, cfg.norm_eps), blk.attn,
                window=w_i, theta=theta[i], cache=layer_cache, pos=pos,
                prefill_kv_dtype=prefill_kv_dtype)
            x = x + h
            m = blk.mlp
            y = swiglu(rms_norm(x, blk.ln2, cfg.norm_eps),
                       m["w_gate"], m["w_up"], m["w_down"])
            x = plan.act(x + y, "batch", "seq", "embed")
            new_layers.append(new_c)
        if cache is not None:
            return x, cache
        if prefill_kv_dtype is None:
            return x, None
        return x, {name: torch.stack([c[name] for c in new_layers])
                   for name in new_layers[0]}

    # -------------------------------------------------------------- decode
    def decode(self, cache, token, pos: int):
        """One serve step.  token [B,1] int; pos int.  Writes the new key and
        value (or the new SSM and conv states) into ``cache`` in place.
        Returns (logits [B,1,V_pad] with the padded vocab masked, cache)."""
        x = self._embed_inputs(token)
        x, cache = self._stack(x, cache=cache, pos=pos)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = torch.einsum("bsd,dv->bsv", x, self._head())
        return self._mask_vocab(logits), cache

    # ----------------------------------------------------------- caches
    def init_cache(self, batch: int, seq: int, kv_dtype: str = "bfloat16"):
        cfg, plan = self.cfg, self.plan
        if cfg.family == "ssm":
            s = cfg.ssm
            di, GN = s.d_inner(cfg.d_model), s.n_groups * s.d_state
            L = cfg.num_layers
            return {"ssm": torch.zeros((L, batch, s.n_heads(cfg.d_model), s.head_dim,
                                        s.d_state), device=self.device),
                    "conv": torch.zeros((L, batch, s.conv_width - 1, di + 2 * GN),
                                        device=self.device)}
        shape = (cfg.num_layers, batch, seq, plan.K, cfg.head_dim)
        dt = torch_dtype(kv_dtype)
        c = {"k": torch.zeros(shape, dtype=dt, device=self.device),
             "v": torch.zeros(shape, dtype=dt, device=self.device)}
        if kv_dtype == "int8":
            c["k_scale"] = torch.zeros(shape[:-1], device=self.device)
            c["v_scale"] = torch.zeros(shape[:-1], device=self.device)
        return c
