"""granite-4.0-h-small [hybrid] — Granite 4.0-H Small (32B-A9B, model type
granitemoehybrid): 40L d_model=4096, tied vocab=100352.  36 Mamba-2 layers
(128 heads of 64, state 128, one B/C group, conv 4, chunk 256) and 4 GQA
layers at indices 5, 15, 25, 35 (32 q / 8 kv heads of 128, no positional
encoding, softmax scale attention_multiplier 1/128).  Every layer is
followed by an MoE FFN: 72 SwiGLU experts of width 768, top-10 with a
softmax over the chosen logits, beside a shared SwiGLU expert of width 1536.
embedding_multiplier 12, residual_multiplier 0.22 on both sub-layers'
outputs, logits divided by logits_scaling 16, RMSNorm eps 1e-5.
[hf:ibm-granite/granite-4.0-h-small/config.json; hf]

All 72 experts are held here (``held=72``), which takes the held MoE path:
no capacity, as the published model drops no token.  Not in ``ARCH_IDS``: the JAX package has no twin of it.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                      # no dense FFN: every layer's FFN is the MoE
    vocab_size=100352,
    moe=MoEConfig(num_experts=72, top_k=10, d_ff_expert=768, every=1,
                  d_ff_shared=1536, held=72),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk_size=256),
    hybrid=HybridConfig(attn_period=10, attn_offset=5),
    norm_eps=1e-5,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=1 / 128,
    rope=False,
    source="[hf:ibm-granite/granite-4.0-h-small; hf]",
))
