"""Toolkit surface (port of ``repro.toolkit``): the target heads so far."""
