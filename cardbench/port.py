"""The program under test: ``repro_torch``'s language model, built from a
configuration file with the drawn weights."""
from __future__ import annotations

import dataclasses

from cardbench import families, weights

# configuration file key -> the program's ModelConfig field, for every family;
# each family's module adds its own (families/__init__.py)
COMMON_FIELDS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
                 "vocab_size": "vocab_size", "tie_word_embeddings": "tie_embeddings",
                 "torch_dtype": "dtype"}


def model_config(cfg):
    """The program's ModelConfig for the configuration file ``cfg``: its
    registered architecture ``port_arch`` with every size the file states."""
    from repro_torch.configs import get_config
    base = get_config(cfg["port_arch"])
    if base.family != cfg["family"]:
        raise ValueError(f"{cfg['name']}: the program's {base.name} is {base.family}, "
                         f"the file says {cfg['family']}")
    fam = families.module(cfg)
    fields = {**COMMON_FIELDS, **fam.FIELDS}
    kw = {field: cfg[key] for key, field in fields.items() if key in cfg}
    for sub, sub_fields in fam.NESTED.items():
        kw[sub] = dataclasses.replace(
            getattr(base, sub), **{field: cfg[key] for key, field in sub_fields.items()})
    return dataclasses.replace(base, **kw)


def build(cfg, w):
    """The program's LM with the drawn weights ``w`` as its parameters."""
    from repro_torch.models.lm import LM
    lm = LM(model_config(cfg), device="meta")
    weights.load_into(lm, cfg, w)
    return lm
