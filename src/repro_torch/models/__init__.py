"""Model definitions (DLRM)."""
