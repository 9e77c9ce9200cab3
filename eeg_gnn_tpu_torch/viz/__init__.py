"""Electrode-graph visualization (networkx and matplotlib, imported inside
the functions: no training or serving path reaches them)."""
