"""Synthetic data of the port (the copy of ``repro.data``)."""
