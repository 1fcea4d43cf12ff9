"""Entry points (the DLRM serving launcher, LM serving on tiered vocab)."""
