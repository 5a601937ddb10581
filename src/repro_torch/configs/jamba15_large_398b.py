"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1
interleave (1 attention layer per period-8 group).  [arXiv:2403.19887; hf]

Assumptions recorded (DESIGN.md §6): MoE on every 2nd layer (Jamba paper's
e=2); SSM blocks use the Mamba-2/SSD formulation with d_state=128 for
uniformity with the assigned mamba2 arch (Jamba-1 used Mamba-1 d_state=16).
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, every=2, offset=1),
    ssm=SSMConfig(d_state=128, head_dim=128, expand=2, n_groups=1,
                  conv_width=4, chunk_size=256),
    hybrid=HybridConfig(attn_period=8, attn_offset=0),
    remat="full",
    source="[arXiv:2403.19887; hf]",
))
