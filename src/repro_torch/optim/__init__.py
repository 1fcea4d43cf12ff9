"""Optimizers of the port (counterpart of ``src/repro/optim``)."""
