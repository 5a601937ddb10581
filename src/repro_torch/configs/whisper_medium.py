"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865, enc-dec with conv frontend (STUB: input_specs() provides
precomputed 1500-frame embeddings).  [arXiv:2212.04356; unverified]

The assigned "24L" is the decoder depth; whisper-medium is symmetric
(24 encoder + 24 decoder layers), which we follow.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    encoder=EncoderConfig(num_layers=24, source_len=1500),
    source="[arXiv:2212.04356; unverified]",
))
