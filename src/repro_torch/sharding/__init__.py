"""Shard placement planning of the port (``src/repro/sharding``)."""
