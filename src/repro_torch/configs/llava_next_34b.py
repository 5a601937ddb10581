"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling.  The vision frontend is a STUB per the brief:
``input_specs()`` provides precomputed patch embeddings prepended to the
token embeddings (anyres: base 576 tokens + 4 tiles x 576 = 2880).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    num_image_tokens=2880,     # anyres: (1 base + 4 tiles) * 576 patches
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
))
