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

On a distributed plan (a DeviceMesh of more than one device) the model's
parameters are DTensors, one per layer, and ``make_sharded_train_step``
takes the state ``{"params": lm's parameters, "opt": the ZeRO-1 state of
train_state_specs}``, the latter in the JAX package's stacked layout: each
microbatch's gradients (partial sums over the data axes) are all-reduced
over the data axes as they are added to the stacked fp32 sums, then
``optimizer.apply_updates_`` updates the state shards.
"""
from __future__ import annotations

import torch

from repro_torch.models.convert import (jax_layout, params_from_jax, stack_params_,
                                       tensor_from_array)
from repro_torch.models.layers import ParamSpec, torch_dtype
from repro_torch.models.lm import LM
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import OptimizerConfig, apply_updates_, init_opt_state
from repro_torch.train.tree import items, leaves, tree_map, unflatten


def make_loss_fn(lm: LM):
    def loss_fn(mb):
        out = lm.forward(mb["tokens"], labels=mb["labels"],
                         embeds_prefix=mb.get("embeds_prefix"),
                         enc_embeds=mb.get("enc_embeds"), row_mask=mb.get("row_mask"),
                         mode="train")
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


def stacked_specs(lm: LM):
    """ParamSpec nest of the JAX package's stacked parameter tree: each
    leaf of ``convert.jax_layout`` with its layers' leading axes
    ("layers", never sharded) before the per-layer spec's axes."""
    by_param = {id(lm.get_parameter(key.replace("/", "."))): spec
                for key, spec in items(lm.param_specs())}
    flat = {}
    for key, (shape, slots) in jax_layout(lm).items():
        s = by_param[id(slots[0][1])]
        flat[key] = ParamSpec(shape, ("layers",) * (len(shape) - len(s.shape)) + s.logical,
                              s.dtype, s.init)
    return unflatten(flat)


def train_state_specs(lm: LM, ocfg: OptimizerConfig):
    """ParamSpec nest for the full train state (dry run / placements): the
    port's per-layer parameter specs, and the optimizer state over the JAX
    package's stacked tree (``stacked_specs``), as the one-device state
    holds it, so that ZeRO-1 cuts each leaf and the int8 state blocks it
    as JAX's does."""
    return {"params": lm.param_specs(),
            "opt": opt_mod.opt_state_specs(stacked_specs(lm), lm.plan, ocfg)}


def param_tree(lm: LM):
    """The model's parameters in the nest of ``lm.param_specs()`` (per-layer
    lists), leaves the ``nn.Parameter`` objects themselves."""
    specs = lm.param_specs()
    it = iter(lm.get_parameter(key.replace("/", ".")) for key, _ in items(specs))
    return tree_map(lambda _: next(it), specs)


def make_sharded_train_step(lm: LM, ocfg: OptimizerConfig, *, grad_dtype: str = "bfloat16"):
    """The train step over DTensor state (see the module docstring):
    (state, batch) -> (state, metrics), ``batch`` of [accum, mb, ...]
    DTensors sharded on the microbatch (``train.data.shard_batch``).  The
    gradients are summed into the stacked leaves of the JAX tree, the
    update runs over stacked copies of the parameters, which are then
    written back to the model's."""
    from torch.distributed.tensor import distribute_tensor
    gdt = torch_dtype(grad_dtype)
    loss_fn = make_loss_fn(lm)
    layout = jax_layout(lm)
    logical = dict(items(stacked_specs(lm)))

    def stacked(key, dtype):
        shape, slots = layout[key]
        p = slots[0][1]
        return distribute_tensor(torch.zeros(shape, dtype=dtype, device=p.to_local().device),
                                 p.device_mesh, lm.plan.placements(*logical[key].logical))

    def train_step(state, batch):
        with lm.spmd():
            gsum = {key: stacked(key, torch.float32) for key in layout}
            lsum = 0.0
            accum = batch["tokens"].shape[0]
            for a in range(accum):
                loss = loss_fn({k: v[a] for k, v in batch.items()})
                loss.backward()
                with torch.no_grad():
                    for key, (_, slots) in layout.items():
                        for idx, p in slots:
                            if p.grad is not None:
                                # Partial over the data axes -> replicated:
                                # the data-parallel all-reduce
                                acc = gsum[key][idx]
                                acc.add_(p.grad.to(gdt).float().redistribute(
                                    acc.device_mesh, acc.placements))
                                p.grad = None
                lsum = lsum + loss.detach().float()
            with torch.no_grad():
                params = {}
                for key, (_, slots) in layout.items():
                    gsum[key].div_(accum)
                    params[key] = stacked(key, slots[0][1].dtype)
                    for idx, p in slots:
                        params[key][idx].copy_(p)
                metrics = apply_updates_(unflatten(params), unflatten(gsum), state["opt"], ocfg)
                for key, (_, slots) in layout.items():
                    for idx, p in slots:
                        p.copy_(params[key][idx])
        return state, dict(metrics, loss=lsum / accum)

    return train_step
