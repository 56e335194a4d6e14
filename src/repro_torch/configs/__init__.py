"""Model builders (the paper's CNNs)."""
