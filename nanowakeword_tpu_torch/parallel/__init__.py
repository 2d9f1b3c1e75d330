"""Data and tensor parallelism over a mesh of torch devices, driven by one
process (mesh.py, collectives.py, dp.py)."""
