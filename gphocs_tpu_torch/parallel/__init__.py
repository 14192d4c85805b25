"""Loci sharding over several processes (parallel/mesh.py)."""
