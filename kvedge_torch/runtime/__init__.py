"""The runtime: config, boot and heartbeats, the device probe, the
payloads, the status server and the profiler."""
