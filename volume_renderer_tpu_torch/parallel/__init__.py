"""Paths that spread one render over several devices."""
