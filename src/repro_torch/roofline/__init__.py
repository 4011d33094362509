"""Roofline analysis on the H100 (twin of ``repro.roofline``)."""
