"""Model forward passes over parameter dictionaries."""
