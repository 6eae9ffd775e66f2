"""Sharding rules of the port: only what a checkpoint manifest needs (the
per-dim mesh axes of a tensor); mesh placement waits for the multi-card
slice."""
