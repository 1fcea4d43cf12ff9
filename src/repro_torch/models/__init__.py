"""Model definitions (DLRM, the dense LM) and the ``build`` facade."""
