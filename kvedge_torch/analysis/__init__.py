"""Static analysis for the port's concurrency contracts.

:mod:`kvedge_torch.analysis.locklint` is the lock-discipline analyzer,
run as ``python -m kvedge_torch.analysis.locklint <paths>``. It is
stdlib-only: it imports (and runs in CI) without torch or a device.
"""
