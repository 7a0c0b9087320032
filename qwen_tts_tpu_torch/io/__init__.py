"""Checkpoint reading and loading."""
