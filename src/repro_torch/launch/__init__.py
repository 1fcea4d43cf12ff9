"""Entry points (serving launcher)."""
