"""Toolkit surface (port of ``repro.toolkit``): the modular
:class:`~repro_torch.toolkit.pipeline.Pipeline` (tokenizer -> embedding ->
encoder -> target) and the target-head registry."""
from repro_torch.toolkit.pipeline import (EmbeddingStage, EncoderStage,
                                          Pipeline, TargetStage,
                                          TokenizerStage)
from repro_torch.toolkit.registry import TARGETS, get_target, register_target
from repro_torch.toolkit.targets import TARGET_FOR_TASK_KIND, TargetSpec

__all__ = ["EmbeddingStage", "EncoderStage", "Pipeline", "TARGETS",
           "TARGET_FOR_TASK_KIND", "TargetSpec", "TargetStage",
           "TokenizerStage", "get_target", "register_target"]
