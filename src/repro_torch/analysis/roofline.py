"""Three-term roofline model for one NVIDIA card: the counterpart of
``repro.analysis.roofline``, whose constants are the TPU v5e's.

    compute term    = FLOPs / peak bf16 dense FLOP/s
    memory term     = HBM bytes / HBM bytes/s
    collective term = collective bytes / NVLink bytes/s each way

All inputs are per-device quantities (analysis/account.py counts at the
local shapes), so each term is per-device seconds, which is the wall-clock
estimate of one step.  The constants are chosen by the card's name
(``torch.cuda.get_device_name``); an unknown name raises.  The host-only
dry run reckons for ``DEFAULT_DEVICE`` and names it in each record.

MODEL_FLOPS = 6 N D (train) / 2 N D (inference) with N = active params:
the ratio MODEL_FLOPS / counted FLOPs measures how much counted compute is
"useful" (catches remat recompute, head padding, capacity-factor waste).
The fields keep the JAX record's names: ``hlo_flops`` is the account's dot
and kernel FLOPs, and ``hlo_flops_raw`` the same count (the port has no
second, trip-count-blind count as XLA's cost_analysis is).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

from repro_torch.analysis.account import StepAccount
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DeviceSpec:
    peak_flops_bf16: float      # dense, per card
    hbm_bw: float               # B/s per card
    link_bw: float              # B/s per card and direction
    source: str


DEVICES = {
    # NVIDIA's H100 SXM data sheet: dense rates, at the full 700 W
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        989e12, 3.35e12, 450e9,
        "NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, "
        "NVLink 900 GB/s (450 GB/s each way)"),
    # NVIDIA's H100 PCIe data sheet: 1,513 TFLOP/s bf16 with sparsity, so
    # 756 dense; 2.0 TB/s HBM2e; NVLink bridge 600 GB/s (300 each way)
    "NVIDIA H100 PCIe": DeviceSpec(
        756e12, 2.0e12, 300e9,
        "NVIDIA H100 PCIe data sheet: 756 TFLOP/s bf16 dense, 2.0 TB/s HBM2e, "
        "NVLink bridge 600 GB/s (300 GB/s each way)"),
}
DEFAULT_DEVICE = "NVIDIA H100 80GB HBM3"


def device_spec(name: str) -> DeviceSpec:
    if name not in DEVICES:
        raise ValueError(f"no roofline constants for device {name!r}; known: "
                         f"{sorted(DEVICES)}")
    return DEVICES[name]


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    # per-device inputs
    hlo_flops: float                  # the account's dot + kernel FLOPs
    hlo_flops_raw: float              # the same count (no second count)
    hbm_bytes: float                  # traffic estimate (account.py)
    collective_bytes: float
    collective_detail: dict
    # model-level
    model_flops_total: float          # 6ND / 2ND across the whole step
    n_devices: int
    # memory
    device_bytes_peak: Optional[float] = None   # from the memory estimate
    device: str = DEFAULT_DEVICE                # the card reckoned for

    @property
    def spec(self) -> DeviceSpec:
        return device_spec(self.device)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.spec.peak_flops_bf16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.spec.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.spec.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """no-overlap upper bound estimate"""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_per_device(self) -> float:
        return self.model_flops_total / max(self.n_devices, 1)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (per device)."""
        if self.hlo_flops <= 0:
            return float("nan")
        return self.model_flops_per_device / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """fraction of the compute roofline achieved on *useful* FLOPs if the
        step ran at the bound: MODEL_FLOPS / (step_time x peak)."""
        return self.fraction_at(self.step_time_s)

    def fraction_at(self, seconds: float) -> float:
        """MODEL_FLOPS per device / (``seconds`` x peak): the share of the
        card's peak that a step taking ``seconds`` gets on useful FLOPs."""
        if seconds <= 0:
            return float("nan")
        return self.model_flops_per_device / (seconds * self.spec.peak_flops_bf16)

    def to_dict(self) -> dict:
        """JAX's keys (the device, which JAX's terms fix, is left out: the
        dry run's record names it)."""
        d = asdict(self)
        d.pop("device")
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 step_time_s=self.step_time_s,
                 useful_flops_fraction=self.useful_flops_fraction,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Whole-step MODEL_FLOPS (all devices): 6*N_active*tokens for training,
    2*N_active*tokens for prefill, 2*N_active*batch for one decode step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


def build_terms(arch: str, cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
                n_devices: int, acct: StepAccount, peak_bytes: Optional[float] = None,
                device: str = DEFAULT_DEVICE) -> RooflineTerms:
    device_spec(device)
    return RooflineTerms(
        arch=arch, shape=shape.name, mesh=mesh_name,
        hlo_flops=acct.flops, hlo_flops_raw=acct.flops,
        hbm_bytes=acct.traffic_bytes,
        collective_bytes=acct.total_collective_bytes,
        collective_detail=dict(acct.collective_bytes),
        model_flops_total=model_flops(cfg, shape),
        n_devices=n_devices, device_bytes_peak=peak_bytes, device=device,
    )
