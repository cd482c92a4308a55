"""Synthetic conditioning data (the JAX package's ``repro.data``)."""
