"""Scripted runs of the milestone configs."""
