"""Post-training quantization (port of ``repro.quant``)."""
