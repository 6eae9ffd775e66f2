"""Optimizers of the port (the copy of ``repro.optim``; the learning-rate
schedules wait for the training slice)."""
