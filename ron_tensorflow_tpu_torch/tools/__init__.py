"""Command-line tools of the port: the learning checks, the training
supervisor, the synthetic dataset and timing tools for the card."""
