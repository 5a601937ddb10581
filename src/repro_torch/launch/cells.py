"""Cell builder: (architecture x input-shape x mesh) -> a runnable step, the
counterpart of ``repro.launch.cells``.

A *cell* bundles the step (train_step / prefill / decode), its inputs and
bookkeeping for the roofline analysis.  Where the JAX package's cell holds
abstract ShapeDtypeStructs to lower, the port's holds tensors: on
``device="meta"`` (the default) they have shapes, types and placements and
no storage, DTensors on a distributed mesh, and ``Cell.run()`` runs the
step abstractly (the dry run); on a real device (a one-device mesh on the
card, or a gloo mesh for prefill and decode) the weights are drawn from
``seed`` and ``run()`` computes.  launch/dryrun.py and chip_smoke.py build cells through this
module, so the dry run runs exactly the code that trains and serves.

``global_batch`` cuts a shape's batch (to fit one card); JAX's builder has
no such cut.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig, get_config,
                                      shape_applicable)
from repro_torch.models.layers import abstract_tree, place
from repro_torch.models.lm import LM, resolve_device
from repro_torch.sharding.plan import ShardingPlan, make_plan
from repro_torch.train.optimizer import OptimizerConfig


@dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    lm: LM
    plan: ShardingPlan
    fn: Callable                 # the step
    args: tuple                  # its inputs (meta tensors on the dry run)
    kind: str                    # train | prefill | decode
    accum_steps: int = 1

    def run(self):
        """Run the step once (train steps update their state in place)."""
        if self.kind == "train":
            return self.fn(*self.args)
        with torch.no_grad():
            return self.fn(*self.args)


def _default_accum(shape: ShapeConfig, plan: ShardingPlan) -> int:
    if not shape.is_training:
        return 1
    if shape.microbatch:
        return max(1, shape.global_batch // shape.microbatch)
    dsz = max(plan.info.data_size, 1)
    # target <= 2 sequences per device per microbatch
    accum = max(1, shape.global_batch // (2 * dsz))
    while shape.global_batch % accum or (shape.global_batch // accum) % dsz:
        accum -= 1
    return max(accum, 1)


class _Inputs:
    """Input tensors of a cell: empty on the meta device, else drawn from a
    seeded generator (token ids uniform over the vocab, embeddings normal x
    0.02), then placed by the plan."""

    def __init__(self, plan: ShardingPlan, device, seed: int):
        self.plan, self.device = plan, device
        self.rng = np.random.default_rng(seed)

    def tokens(self, shape, vocab, spec):
        if self.device.type == "meta":
            t = torch.empty(shape, dtype=torch.long, device="meta")
        else:
            t = torch.from_numpy(self.rng.integers(0, vocab, size=shape)).to(self.device)
        return place(t, self.plan, spec)

    def row_mask(self, accum, mb, mb_pad, spec):
        t = torch.zeros((accum, mb_pad), device=self.device)
        if self.device.type != "meta":
            t[:, :mb] = 1.0
        return place(t, self.plan, spec)

    def embeds(self, shape, spec):
        if self.device.type == "meta":
            t = torch.empty(shape, dtype=torch.float32, device="meta")
        else:
            t = torch.from_numpy(
                self.rng.standard_normal(shape, dtype=np.float32) * 0.02).to(self.device)
        return place(t, self.plan, spec)


def _batch_specs(cfg: ModelConfig, shape: ShapeConfig, plan: ShardingPlan, accum: int,
                 inputs: _Inputs):
    """Train batch [accum, mb, ...]; on a mesh whose data shards do not
    divide the microbatch, padded by zero rows as XLA pads it, with the
    ``row_mask`` of ``train.data.pad_batch``."""
    from repro_torch.train.data import pad_rows
    mb = shape.global_batch // accum
    d = plan.spec("batch")[0]
    mb_pad = pad_rows(plan, mb) if plan.info.distributed else mb
    S = shape.seq_len
    n_img = cfg.num_image_tokens
    S_tok = S - n_img if n_img else S
    out = {
        "tokens": inputs.tokens((accum, mb_pad, S_tok), cfg.vocab_size, (None, d, None)),
    }
    out["labels"] = out["tokens"]
    if mb_pad != mb:
        out["row_mask"] = inputs.row_mask(accum, mb, mb_pad, (None, d))
    if cfg.encoder is not None:
        out["enc_embeds"] = inputs.embeds((accum, mb_pad, cfg.encoder.source_len, cfg.d_model),
                                          (None, d, None, None))
    if n_img:
        out["embeds_prefix"] = inputs.embeds((accum, mb_pad, n_img, cfg.d_model),
                                             (None, d, None, None))
    return out


def input_specs(arch: str, shape_name: str, mesh=None, **kwargs):
    """Public helper: the inputs of a cell (meta tensors by default)."""
    return build_cell(arch, shape_name, mesh, **kwargs).args


def build_cell(arch: str, shape_name: str, mesh=None, *, reduced: bool = False,
               accum: Optional[int] = None, ocfg: Optional[OptimizerConfig] = None,
               overrides: Optional[dict] = None, device="meta", seed: int = 0,
               global_batch: Optional[int] = None) -> Cell:
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if reduced:
        shape = replace(shape, seq_len=64 if shape.kind != "decode" else 64,
                        global_batch=4, kv_cache_dtype=shape.kv_cache_dtype)
    if global_batch is not None:
        shape = replace(shape, global_batch=global_batch)
    if not shape_applicable(cfg, shape):
        raise ValueError(f"{arch} x {shape_name}: inapplicable "
                         f"(sub-quadratic shape on full-attention arch)")
    plan = make_plan(cfg, mesh)
    dev = resolve_device(device)
    lm = LM(cfg, plan, device=dev, seed=seed)
    inputs = _Inputs(plan, dev, seed + 1)
    ocfg = ocfg or OptimizerConfig()

    if shape.kind == "train":
        return _build_train(arch, cfg, shape, lm, plan, accum, ocfg, inputs)
    if shape.kind == "prefill":
        return _build_prefill(arch, cfg, shape, lm, plan, inputs)
    return _build_decode(arch, cfg, shape, lm, plan, inputs)


def _build_train(arch, cfg, shape, lm, plan, accum, ocfg, inputs) -> Cell:
    from repro_torch.train import train_step as ts
    accum = accum or _default_accum(shape, plan)
    batch = _batch_specs(cfg, shape, plan, accum, inputs)
    lm.requires_grad_(True)
    if plan.info.distributed:
        if inputs.device.type != "meta":
            raise ValueError("a train cell on a distributed mesh is the dry run's: "
                             "device='meta'")
        state = {"params": ts.param_tree(lm),
                 "opt": abstract_tree(ts.train_state_specs(lm, ocfg)["opt"], plan)}
        step_fn = ts.make_sharded_train_step(lm, ocfg)
    else:
        state = ts.init_train_state(lm, ocfg)
        step_fn = ts.make_train_step(lm, ocfg)
    return Cell(arch=arch, shape=shape, lm=lm, plan=plan, fn=step_fn,
                args=(state, batch), kind="train", accum_steps=accum)


def _batch_ax(plan, B):
    d = plan.spec("batch")[0]
    return d if (d is not None and B % plan.info.data_size == 0) else None


def _build_prefill(arch, cfg, shape, lm, plan, inputs) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    d = _batch_ax(plan, B)
    n_img = cfg.num_image_tokens
    S_tok = S - n_img if n_img else S
    extras = {}
    if cfg.encoder is not None:
        extras["enc_embeds"] = inputs.embeds((B, cfg.encoder.source_len, cfg.d_model),
                                             (d, None, None))
    if n_img:
        extras["embeds_prefix"] = inputs.embeds((B, n_img, cfg.d_model), (d, None, None))
    tokens = inputs.tokens((B, S_tok), cfg.vocab_size, (d, None))
    kv_dtype = shape.kv_cache_dtype if shape.kv_cache_dtype else "bfloat16"

    def prefill_fn(tokens, extras):
        return lm.forward(tokens, mode="prefill", kv_dtype=kv_dtype, **extras)

    return Cell(arch=arch, shape=shape, lm=lm, plan=plan, fn=prefill_fn,
                args=(tokens, extras), kind="prefill")


def _build_decode(arch, cfg, shape, lm, plan, inputs) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    if inputs.device.type == "meta":
        cache = lm.cache_struct(B, S, shape.kv_cache_dtype)
    else:
        cache = lm.init_cache(B, S, shape.kv_cache_dtype)
    token = inputs.tokens((B, 1), cfg.vocab_size, (_batch_ax(plan, B), None))
    pos = S - 1          # the last position: the step reads the whole cache

    def decode_fn(cache, token, pos):
        return lm.decode(cache, token, pos)

    return Cell(arch=arch, shape=shape, lm=lm, plan=plan, fn=decode_fn,
                args=(cache, token, pos), kind="decode")


def all_cells(include_inapplicable: bool = False):
    """The assigned 10 x 4 matrix minus documented skips (DESIGN.md §6)."""
    from repro_torch.configs.all_configs import ARCH_IDS
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            ok = shape_applicable(cfg, SHAPES[sname])
            if ok or include_inapplicable:
                out.append((arch, sname, ok))
    return out
