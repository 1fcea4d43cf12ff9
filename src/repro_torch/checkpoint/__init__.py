"""Checkpoints of the port (counterpart of ``src/repro/checkpoint``)."""
