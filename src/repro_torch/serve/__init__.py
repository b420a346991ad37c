"""Encoder serving (port of ``repro.serve``): the bucketed runtime, the
micro-batching scheduler and the encoder engine."""
from repro_torch.serve.encoder import EncoderServeEngine
from repro_torch.serve.runtime import Runtime, bucket_size
from repro_torch.serve.scheduler import EncoderRequest, MicroBatcher

__all__ = ["EncoderServeEngine", "EncoderRequest", "MicroBatcher", "Runtime",
           "bucket_size"]
