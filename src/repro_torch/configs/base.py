"""Configuration dataclasses for the repro framework.

Every assigned architecture is expressed as a :class:`ModelConfig`; every
assigned input shape as a :class:`ShapeConfig`.  Full-size configs are only
ever *lowered* (ShapeDtypeStruct dry-runs); smoke tests use
``ModelConfig.reduced()`` which shrinks every extensive dimension while
keeping the family topology (GQA ratio, MoE top-k, hybrid interleave, ...).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # every `every`-th layer (1-indexed offset `offset`) is a MoE layer;
    # every=1 -> all layers are MoE.
    every: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # a shared SwiGLU expert of this width beside the routed ones (0: none)
    d_ff_shared: int = 0
    # the experts this device holds, [first_held, first_held + held) of
    # num_experts.  held > 0 takes the held path: the router scores all of
    # them, and every pair of a held one is computed here, with no capacity
    # (one device's share of an expert-parallel deployment, with no
    # exchange).  held 0: the capacity paths over all experts.
    held: int = 0
    first_held: int = 0

    def is_moe_layer(self, layer_idx: int) -> bool:
        return layer_idx % self.every == self.offset % self.every

    @property
    def held_range(self) -> tuple:
        """(first, end) of the experts held here."""
        n = self.held or self.num_experts
        return self.first_held, self.first_held + n


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block hyper-parameters [arXiv:2405.21060]."""
    d_state: int = 128
    head_dim: int = 64           # P in the SSD paper
    expand: int = 2              # d_inner = expand * d_model
    n_groups: int = 1            # B/C groups (grouped like GQA)
    conv_width: int = 4
    chunk_size: int = 256        # SSD block-decomposition chunk length
    dt_min: float = 1e-3
    dt_max: float = 1e-1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Interleave pattern for hybrid (attention + SSM) stacks.

    ``attn_period=8`` means layer indices where ``idx % 8 == attn_offset``
    are attention layers and the rest are SSM layers (Jamba's 1:7).
    """
    attn_period: int = 8
    attn_offset: int = 0


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec models (whisper).  The modality frontend is
    a stub: ``input_specs`` provides precomputed frame embeddings."""
    num_layers: int = 24
    source_len: int = 1500       # whisper: 30s audio -> 1500 frames


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # sliding-window pattern: window>0 with global_every=N means layers where
    # (idx % global_every == global_every-1) are global, the rest local
    # (gemma3's 5:1 local:global). window<=0 -> all layers global.
    sliding_window: int = 0
    global_every: int = 0

    # --- family extensions --------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encoder: Optional[EncoderConfig] = None
    # vlm stub: number of precomputed image-patch embeddings prepended
    num_image_tokens: int = 0

    # --- numerics / implementation -----------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attention_impl: str = "auto"   # auto | dot | chunked | flash
    attention_chunk: int = 1024    # kv-chunk for the online-softmax path
    moe_impl: str = "auto"         # auto | dense | sharded
    moe_gather: str = "auto"       # auto | weights | partial (FSDP strategy)
    remat: str = "dots"            # none | dots | full
    source: str = ""               # provenance tag [source; tier]

    # --- scalars of Granite 4.0's layer (granitemoehybrid) -----------------
    # Each default leaves the model as it was.  They are kept out of the
    # repr, so that a config that leaves them at their defaults prints as it
    # did before they existed.
    # the embedding is multiplied by this (None: sqrt(d_model))
    embedding_multiplier: Optional[float] = field(default=None, repr=False)
    # each sub-layer's output is multiplied by this before the residual add
    residual_multiplier: float = field(default=1.0, repr=False)
    # the logits are divided by this
    logits_scaling: float = field(default=1.0, repr=False)
    # the attention's softmax scale (None: 1/sqrt(head_dim))
    attention_multiplier: Optional[float] = field(default=None, repr=False)
    # rotary positions in attention; False: none (NoPE)
    rope: bool = field(default=True, repr=False)

    # ------------------------------------------------------------------ api
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def is_attn_layer(self, idx: int) -> bool:
        if self.hybrid is None:
            return self.ssm is None
        return idx % self.hybrid.attn_period == self.hybrid.attn_offset

    def is_global_attn_layer(self, idx: int) -> bool:
        if self.sliding_window <= 0 or self.global_every <= 0:
            return True
        return idx % self.global_every == self.global_every - 1

    def is_moe_layer(self, idx: int) -> bool:
        return self.moe is not None and self.moe.is_moe_layer(idx)

    @property
    def supports_long_context(self) -> bool:
        """True iff sequence mixing is sub-quadratic end-to-end (pure SSM or
        hybrid whose attention layers can use a sharded cache).  Full- or
        windowed-attention-with-global-layers archs do NOT qualify."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    # ---------------------------------------------------------- param count
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6 N D)."""
        D, V = self.d_model, self.vocab_size
        n = V * D * (1 if self.tie_embeddings else 2)  # embed + lm head
        n += D  # final norm
        for i in range(self.num_layers):
            n += 2 * D  # pre-norms
            if self.is_attn_layer(i):
                n += D * self.q_dim + self.q_dim * D          # wq, wo
                n += 2 * D * self.kv_dim                       # wk, wv
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
            elif self.ssm is not None:
                n += self._ssm_params()
            if self.family == "ssm":
                continue  # pure-SSM blocks have no separate FFN
            if self.is_moe_layer(i):
                m = self.moe
                lo, hi = m.held_range
                n += D * m.num_experts                         # router
                n += (hi - lo) * 3 * D * m.d_ff_expert         # swiglu experts held
                n += 3 * D * m.d_ff_shared                     # shared expert
            else:
                n += 3 * D * self.d_ff                         # swiglu dense
        if self.encoder is not None:
            e = self.encoder
            for _ in range(e.num_layers):
                n += 2 * D
                n += 2 * (D * self.q_dim + 2 * D * self.kv_dim)  # self (enc)
                n += 3 * D * self.d_ff
            # decoder cross-attention (counted here, one per decoder layer)
            n += self.num_layers * (D * self.q_dim + self.q_dim * D
                                    + 2 * D * self.kv_dim + D)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts, of which the
        held share is computed here)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        total = self.param_count()
        moe_layers = sum(1 for i in range(self.num_layers) if self.is_moe_layer(i))
        lo, hi = m.held_range
        all_expert = moe_layers * (hi - lo) * 3 * self.d_model * m.d_ff_expert
        active_expert = (moe_layers * m.top_k * (hi - lo) * 3 * self.d_model
                         * m.d_ff_expert // m.num_experts)
        return total - all_expert + active_expert

    def _ssm_params(self) -> int:
        s, D = self.ssm, self.d_model
        di = s.d_inner(D)
        nh = s.n_heads(D)
        proj_in = D * (2 * di + 2 * s.n_groups * s.d_state + nh)
        conv = s.conv_width * (di + 2 * s.n_groups * s.d_state)
        return proj_in + conv + 2 * nh + di + di * D  # A,dt_bias,norm,out

    # ------------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Tiny same-topology config for CPU smoke tests."""
        kw = dict(
            # a hybrid stack keeps one whole period
            num_layers=min(self.num_layers, 4 if self.hybrid is None else self.hybrid.attn_period),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            sliding_window=16 if self.sliding_window > 0 else 0,
            global_every=self.global_every if self.global_every > 0 else 0,
            attention_chunk=32,
            num_image_tokens=8 if self.num_image_tokens > 0 else 0,
            remat="none",
        )
        if self.moe is not None:
            m = self.moe
            E = min(m.num_experts, 8)
            kw["moe"] = replace(m, num_experts=E, top_k=min(m.top_k, 2), d_ff_expert=64,
                                d_ff_shared=128 if m.d_ff_shared else 0,
                                held=m.held * E // m.num_experts,
                                first_held=m.first_held * E // m.num_experts)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk_size=16)
        if self.encoder is not None:
            kw["encoder"] = replace(self.encoder, num_layers=2, source_len=24)
        if self.hybrid is not None:
            kw["hybrid"] = self.hybrid
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode
    kv_cache_dtype: str = "bfloat16"   # int8 available for big decode cells
    # training only:
    microbatch: Optional[int] = None   # grad-accum microbatch (None = auto)

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode",
                         kv_cache_dtype="int8")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode",
                        kv_cache_dtype="int8")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> bool:
    """Assigned-shape applicability rules (see DESIGN.md §6)."""
    if shape.name == "long_500k":
        return model.supports_long_context
    return True


# Registry ------------------------------------------------------------------
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # populate lazily so `import repro_torch.configs.base` has no side effects
    if not _REGISTRY:
        from repro_torch.configs import all_configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    if not _REGISTRY:
        from repro_torch.configs import all_configs  # noqa: F401
    return sorted(_REGISTRY)
