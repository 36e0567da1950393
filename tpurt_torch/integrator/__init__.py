"""Wavefront path integrator, and the brute-force oracle
(integrator/oracle.py)."""

from tpurt_torch.integrator.wavefront import MAX_WAVES, render_sample, trace_paths

__all__ = ["MAX_WAVES", "render_sample", "trace_paths"]
