"""Model code (port of ``repro.models``): the encoder building blocks, the
config-driven model and its training loss."""
from repro_torch.models import layers, rglru, transformer, xlstm  # noqa: F401
from repro_torch.models.transformer import (QuantScheme, build_plan,
                                            decode_step, forward,
                                            init_caches, init_params,
                                            lm_loss)

__all__ = ["layers", "rglru", "transformer", "xlstm", "QuantScheme",
           "build_plan", "decode_step", "forward", "init_caches",
           "init_params", "lm_loss"]
