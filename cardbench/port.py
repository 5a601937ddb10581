"""The program under test: ``repro_torch``'s language model, built from a
configuration file with the drawn weights."""
from __future__ import annotations

import dataclasses

from cardbench import weights

# configuration file key -> the program's ModelConfig field, by family
FIELDS = {
    "dense": {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
              "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
              "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
              "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
              "tie_word_embeddings": "tie_embeddings", "torch_dtype": "dtype",
              "attention_impl": "attention_impl"},
    "ssm": {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
            "vocab_size": "vocab_size", "layer_norm_epsilon": "norm_eps",
            "tie_word_embeddings": "tie_embeddings", "torch_dtype": "dtype"},
}
SSM_FIELDS = {"state_size": "d_state", "head_dim": "head_dim", "expand": "expand",
              "n_groups": "n_groups", "conv_kernel": "conv_width", "chunk_size": "chunk_size"}


def model_config(cfg):
    """The program's ModelConfig for the configuration file ``cfg``: its
    registered architecture ``port_arch`` with every size the file states."""
    from repro_torch.configs import get_config
    base = get_config(cfg["port_arch"])
    if base.family != cfg["family"]:
        raise ValueError(f"{cfg['name']}: the program's {base.name} is {base.family}, "
                         f"the file says {cfg['family']}")
    kw = {field: cfg[key] for key, field in FIELDS[cfg["family"]].items() if key in cfg}
    if cfg["family"] == "ssm":
        kw["ssm"] = dataclasses.replace(
            base.ssm, **{field: cfg[key] for key, field in SSM_FIELDS.items()})
    return dataclasses.replace(base, **kw)


def build(cfg, w):
    """The program's LM with the drawn weights ``w`` as its parameters."""
    from repro_torch.models.lm import LM
    lm = LM(model_config(cfg), device="meta")
    weights.load_into(lm, cfg, w)
    return lm
