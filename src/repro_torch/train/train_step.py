"""Train step: gradient accumulation over microbatches, each microbatch's
gradient cast to ``grad_dtype`` and summed in fp32, then AdamW: the
counterpart of ``repro.train.train_step`` on one device.

``state = {"params": ..., "opt": ...}`` in the JAX package's layout: the
parameters stacked per JAX leaf ([L, ...] for a layer's weights), the
optimizer state (m, v, master, step) likewise.  ``init_train_state`` makes
the model's parameters trainable views into ``state["params"]``
(``convert.stack_params_``), so the model trains on the state that a
checkpoint saves, and the int8 state's blocks of 256 run over the same
flattened stacked leaves as JAX's.  The step updates the state in place
and returns it with the metrics {"loss", "lr", "grad_norm"}.
"""
from __future__ import annotations

import torch

from repro_torch.models.convert import (jax_layout, params_from_jax, stack_params_,
                                       tensor_from_array)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import OptimizerConfig, apply_updates_, init_opt_state
from repro_torch.train.tree import items, unflatten


def make_loss_fn(lm: LM):
    def loss_fn(mb):
        out = lm.forward(mb["tokens"], labels=mb["labels"],
                         embeds_prefix=mb.get("embeds_prefix"),
                         enc_embeds=mb.get("enc_embeds"), mode="train")
        return out["loss"]
    return loss_fn


def loss_and_grads(lm: LM, batch: dict, grad_dtype: str = "bfloat16"):
    """The mean loss over the microbatches of ``batch`` ([accum, mb, ...]
    tensors on the model's device) and the mean gradient in JAX's layout,
    fp32: each microbatch's backward, then ``add_grads_``."""
    loss_fn = make_loss_fn(lm)
    layout = jax_layout(lm)
    gsum = {key: torch.zeros(shape, dtype=torch.float32, device=lm.device)
            for key, (shape, _) in layout.items()}
    lsum = torch.zeros((), dtype=torch.float32, device=lm.device)
    accum = batch["tokens"].shape[0]
    for a in range(accum):
        loss = loss_fn({k: v[a] for k, v in batch.items()})
        loss.backward()
        add_grads_(gsum, layout, grad_dtype)
        lsum += loss.detach().float()
    for g in gsum.values():
        g.div_(accum)
    return lsum / accum, unflatten(gsum)


@torch.no_grad()
def add_grads_(gsum: dict, layout, grad_dtype: str):
    """Add each parameter's ``.grad``, cast to ``grad_dtype``, into its slice
    of the stacked fp32 sums ``gsum`` ({key path: [L, ...]}, as
    ``convert.jax_layout`` stacks them), and drop the ``.grad``."""
    gdt = torch_dtype(grad_dtype)
    for key, (_, slots) in layout.items():
        for idx, p in slots:
            if p.grad is not None:
                gsum[key][idx].add_(p.grad.to(gdt).float())
                p.grad = None


def make_train_step(lm: LM, ocfg: OptimizerConfig, *, grad_dtype: str = "bfloat16"):
    """grad_dtype: the type of each microbatch's gradient before it is
    summed (bf16 = the JAX package's gradient compression; fp32 = exact).
    The sum over microbatches is always fp32."""

    def train_step(state, batch):
        loss, grads = loss_and_grads(lm, batch, grad_dtype)
        metrics = apply_updates_(state["params"], grads, state["opt"], ocfg)
        return state, dict(metrics, loss=loss)

    return train_step


def init_train_state(lm: LM, ocfg: OptimizerConfig, jax_state=None):
    """The train state of ``lm``: its parameters made trainable and stacked
    (``lm`` trains on ``state["params"]`` from here on), a zero optimizer
    state with the master from the parameters.  ``jax_state`` (a JAX train
    state as nested dicts of arrays) replaces both."""
    if jax_state is not None:
        params_from_jax(lm, jax_state["params"])
    lm.requires_grad_(True)
    params = stack_params_(lm)
    state = {"params": params, "opt": init_opt_state(params, ocfg)}
    if jax_state is not None:
        load_state_(state, {"opt": jax_state["opt"]})
    return state


@torch.no_grad()
def load_state_(state, tree):
    """Copy the leaves of ``tree`` (tensors, or arrays of either framework:
    a restored checkpoint, a JAX state) into the matching leaves of
    ``state`` in place, casting to each target's type; every key path of
    ``tree`` must be in ``state`` with the same shape."""
    target = dict(items(state))
    for key, leaf in items(tree):
        if key not in target:
            raise KeyError(f"state has no leaf {key!r}")
        src = leaf if isinstance(leaf, torch.Tensor) else tensor_from_array(leaf)
        if tuple(src.shape) != tuple(target[key].shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(src.shape)} vs state "
                             f"{tuple(target[key].shape)}")
        target[key].copy_(src)
