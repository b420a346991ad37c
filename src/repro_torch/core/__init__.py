"""SAMP core (port of ``repro.core``): quantization numerics, calibrators,
the per-layer precision lattice and the PrecisionPlan schema."""
