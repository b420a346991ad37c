"""Model code (port of ``repro.models``): the encoder building blocks and
the config-driven model."""
