"""The flagship decoder, paged cache, sampling and server in PyTorch."""
