"""Import every assigned architecture config so the registry is populated."""
from repro_torch.configs import (  # noqa: F401
    gemma3_4b,
    qwen15_32b,
    granite3_8b,
    internlm2_1_8b,
    mamba2_1_3b,
    qwen3_moe_235b,
    phi35_moe_42b,
    llava_next_34b,
    whisper_medium,
    jamba15_large_398b,
)

ARCH_IDS = [
    "gemma3-4b",
    "qwen1.5-32b",
    "granite-3-8b",
    "internlm2-1.8b",
    "mamba2-1.3b",
    "qwen3-moe-235b-a22b",
    "phi3.5-moe-42b-a6.6b",
    "llava-next-34b",
    "whisper-medium",
    "jamba-1.5-large-398b",
]
