"""Serving system: traces, residency engine, tiered store, RecMG outputs."""
