"""Measurements of the port on the card."""
