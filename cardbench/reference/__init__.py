"""Plain float32 references, one module per model family, each with
``logits(weights, cfg, tokens, positions, fp8=False)``."""
