"""The LM substrate: parameter trees, layers and the decoder stack."""
