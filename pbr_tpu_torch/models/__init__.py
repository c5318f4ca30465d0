"""Renderers: the wavefront integrator and the progressive PathTracer."""
