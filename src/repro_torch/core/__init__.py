"""Graph IR, rewrite passes and the PyTorch executors."""
