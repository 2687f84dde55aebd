"""Scale-out over a (dp, mp) grid of devices (parallel/mesh.py)."""
