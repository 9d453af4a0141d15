"""Checkpoints, image grids and run directories."""
