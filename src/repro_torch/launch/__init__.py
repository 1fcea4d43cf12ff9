"""Entry points (the DLRM serving launcher, LM serving on tiered vocab, the
LM training launcher and its train step)."""
