"""FaaS execution layer: one engine, pluggable platforms, adaptive control.

The port's copy of ``repro.faas`` (NumPy only)::

    SuitePlan (core/rmit) ──► ExecutionEngine (engine.py) ──► EngineReport
                                   │      ▲
                     PlatformBackend      EngineObserver
                      (backends.py)       (e.g. AdaptiveController,
                                           core/controller.py)

``ExecutionEngine`` is the single event-driven scheduler: concurrency
slots, warm-instance pools, cold starts, retries, straggler hedging and
billing.  Simulated backends (``LambdaLikeBackend``, ``GCFLikeBackend``,
``AzureLikeBackend``, ``VMBackend``) run in virtual time;
``LocalDuetBackend`` runs real duets on host threads in wall-clock time,
which is how the kernel-duet suite times its PyTorch duets on the card.

``VectorEngine`` (engine_vec.py) is the same scheduler as wave-batched
NumPy arrays, bit-for-bit identical to ``ExecutionEngine``; runs it
cannot vectorise (streaming observers, shared warm pools, realtime
backends, active chaos) fall back to the scalar loop and are logged.
``make_engine(backend, cfg, engine="fast"|"reference"|None)`` is the
factory, "fast" the default.

``ChaosBackend`` (chaos.py) wraps a virtual-time backend with seeded
performance regimes (traces.py) and injected faults; at zero intensity it
is an exact identity.  Both engines feed the observability context
(``repro_torch.obs``) when one is installed, and only read what they
already computed.
"""
from repro_torch.faas.backends import (AZURE_PROFILE, AzureLikeBackend,
                                       GCF_PROFILE, GCFLikeBackend,
                                       LAMBDA_PROFILE, LambdaLikeBackend,
                                       LocalDuetBackend, PROVIDER_PROFILES,
                                       ProviderProfile, SimFaaSBackend,
                                       VMBackend)
from repro_torch.faas.engine import (CompletedInvocation, EngineConfig,
                                     EngineObserver, EngineReport,
                                     ExecutionEngine, FanoutObserver,
                                     Instance, InvocationOutcome, WarmPool)
from repro_torch.faas.engine_vec import (VectorEngine, make_engine,
                                         set_default_engine)
from repro_torch.faas.platform import (FaaSPlatformConfig, SimReport,
                                       SimWorkload, SimulatedFaaS,
                                       SimulatedVM, VMPlatformConfig,
                                       make_provider_backend)

__all__ = [
    "AZURE_PROFILE", "AzureLikeBackend", "CompletedInvocation",
    "EngineConfig", "EngineObserver", "EngineReport", "ExecutionEngine",
    "FaaSPlatformConfig", "FanoutObserver", "GCF_PROFILE", "GCFLikeBackend",
    "Instance", "InvocationOutcome", "LAMBDA_PROFILE", "LambdaLikeBackend",
    "LocalDuetBackend", "PROVIDER_PROFILES", "ProviderProfile",
    "SimFaaSBackend", "SimReport", "SimWorkload", "SimulatedFaaS",
    "SimulatedVM", "VMBackend", "VMPlatformConfig", "VectorEngine",
    "WarmPool", "make_engine", "make_provider_backend",
    "set_default_engine",
]
