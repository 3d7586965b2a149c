"""Lattice maths, torus indexing and the LRAM memory layer (torch)."""
