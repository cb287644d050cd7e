"""Test harnesses of the port: seeded fault injection at the serving
path's device seams (``servingfaults``)."""
