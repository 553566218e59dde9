"""Cluster model pieces the serving path needs."""
