"""Toolkit surface (port of ``repro.toolkit``): the modular
:class:`~repro_torch.toolkit.pipeline.Pipeline` (tokenizer -> embedding ->
encoder -> target), the :class:`~repro_torch.toolkit.samp.SAMP` facade
(``from_config`` / ``calibrate`` / ``autotune`` / ``save`` / ``load`` /
``serve``), the compute-backend, target-head and latency-backend
registries, the roofline and wallclock latency backends, and deployable
artifact bundles."""
from repro_torch.core.plan import LayerPlan, PrecisionPlan, QuantSpec
from repro_torch.core.samp import SEARCH_STRATEGIES, register_strategy
from repro_torch.kernels.backend import (BACKENDS, ComputeBackend,
                                         get_backend, register_backend)
from repro_torch.toolkit import artifact, latency, registry, targets
from repro_torch.toolkit.artifact import Artifact, load_artifact, save_artifact
from repro_torch.toolkit.latency import (LatencyBackend, RooflineBackend,
                                         WallclockBackend, encoder_latency,
                                         layer_latency, layer_ops)
from repro_torch.toolkit.pipeline import (EmbeddingStage, EncoderStage,
                                          Pipeline, TargetStage,
                                          TokenizerStage)
from repro_torch.toolkit.registry import (LATENCY_BACKENDS, TARGETS,
                                          get_latency_backend, get_target,
                                          register_latency_backend,
                                          register_target)
from repro_torch.toolkit.samp import SAMP, AutotuneReport
from repro_torch.toolkit.targets import TARGET_FOR_TASK_KIND, TargetSpec

__all__ = [
    "PrecisionPlan", "LayerPlan", "QuantSpec",
    "SEARCH_STRATEGIES", "register_strategy",
    "BACKENDS", "ComputeBackend", "get_backend", "register_backend",
    "SAMP", "AutotuneReport", "Pipeline", "TargetSpec",
    "TARGET_FOR_TASK_KIND",
    "TokenizerStage", "EmbeddingStage", "EncoderStage", "TargetStage",
    "Artifact", "save_artifact", "load_artifact",
    "LatencyBackend", "RooflineBackend", "WallclockBackend",
    "encoder_latency", "layer_latency", "layer_ops",
    "TARGETS", "LATENCY_BACKENDS", "register_target", "get_target",
    "register_latency_backend", "get_latency_backend",
    "registry", "targets", "latency", "artifact",
]
