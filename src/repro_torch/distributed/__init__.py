"""Fault-tolerance and compression helpers of the port (counterpart of
``src/repro/distributed``)."""
