"""Sampling, geometry, shading and the forward march (plain and kernel)."""
