"""mamba2-1.3b [ssm] — 48L d_model=2048, attention-free, vocab=50280,
ssm_state=128 (SSD, state-space duality).  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,          # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,               # Mamba blocks subsume the FFN
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk_size=256),
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
))
