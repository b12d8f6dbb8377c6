"""Checkpoint save and load."""
