"""Wavefront path integrator."""
