"""Query generators of the port (copies of ``src/repro/data``)."""
