"""Training input: the corpus format and the token-batch feeder."""
