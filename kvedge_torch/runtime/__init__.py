"""Serving config, device probe and the serve payload."""
