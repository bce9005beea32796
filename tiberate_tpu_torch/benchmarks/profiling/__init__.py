"""Probes of single kernels on the card."""
