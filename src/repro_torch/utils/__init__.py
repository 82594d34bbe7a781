"""Pytree helpers and device resolution."""
