"""A dense GQA decoder (InternLM2's layer): pre-norm, grouped-query
attention through K1 in prefill, a SwiGLU feed-forward.

In the drawn weights the first query head of each group shares its key
head's projection (wq[:, group g, 0] = wk[:, g]).  A token's own key then
scores |q|^2 / sqrt(head size), about 11 at head size 128, against about 1
for any other key, and takes most of that head's attention even at 32k
positions (a trained model attends much to itself and its neighbours too).
With independent projections the attention is near uniform, and a decode
step that never writes its own key into the cache would move the output by
a thirty-thousandth: the served tokens could not show it.
"""
from __future__ import annotations

import contextlib

from cardbench.faults import patched
from cardbench.weights import stacked
from cardbench.yardstick import k1_work

FIELDS = {"num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
          "head_dim": "head_dim", "intermediate_size": "d_ff", "rope_theta": "rope_theta",
          "rms_norm_eps": "norm_eps", "attention_impl": "attention_impl"}
NESTED = {}
# the program's module of each layer weight, in its parameter names
GROUPS = {"ln1": "", "ln2": "", "wq": "attn.", "wk": "attn.", "wv": "attn.", "wo": "attn.",
          "w_gate": "mlp.", "w_up": "mlp.", "w_down": "mlp."}


def _attention_shape(cfg):
    """(q heads, kv heads, head size) of an attention layer of ``cfg``."""
    H = cfg["num_attention_heads"]
    return H, cfg["num_key_value_heads"], cfg.get("head_dim", cfg["hidden_size"] // H)


def specs(cfg) -> dict:
    D = cfg["hidden_size"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, F = cfg["head_dim"], cfg["intermediate_size"]
    return stacked(cfg["num_hidden_layers"], {
        "ln1": ((D,), "normal", 0.1), "ln2": ((D,), "normal", 0.1),
        "wq": ((D, H, hd), "normal", D ** -0.5),
        "wk": ((D, K, hd), "normal", D ** -0.5),
        "wv": ((D, K, hd), "normal", D ** -0.5),
        "wo": ((H, hd, D), "normal", (H * hd) ** -0.5),
        "w_gate": ((D, F), "normal", D ** -0.5),
        "w_up": ((D, F), "normal", D ** -0.5),
        "w_down": ((F, D), "normal", F ** -0.5)})


def after_draw(cfg, w):
    """Tie the first query head of each group to its key head."""
    L, D, H, hd = w["layers.wq"].shape
    K = cfg["num_key_value_heads"]
    w["layers.wq"].view(L, D, K, H // K, hd)[:, :, :, 0] = w["layers.wk"]


def param_name(cfg, key, i):
    return f"blocks.{i}.{GROUPS[key]}{key}"


def projection_params(cfg) -> int:
    D = cfg["hidden_size"]
    H, K, hd = _attention_shape(cfg)
    per_layer = D * H * hd * 2 + D * K * hd * 2 + 3 * D * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * per_layer


def mixer_flops(cfg, seq) -> int:
    """Causal attention's score and value products, every layer."""
    H, K, hd = _attention_shape(cfg)
    return cfg["num_hidden_layers"] * k1_work(1, H, K, seq, seq, hd)[0]


@contextlib.contextmanager
def state_unchanged():
    """The cache never gets the new key and value."""
    from repro_torch.models import lm
    with patched(lm, "_write_pos", lambda buf, pos, val: None):
        yield
