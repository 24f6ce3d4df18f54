"""Command-line entry points of the port, and its device meshes
(`mesh.py`)."""
