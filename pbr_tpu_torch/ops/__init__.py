"""Tensor ops: vec math, RNG, intersection, BRDFs, kernel wrappers."""
