"""Spectral operators of the port."""
