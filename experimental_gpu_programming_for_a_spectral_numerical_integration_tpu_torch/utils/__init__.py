"""Diagnostics, timing and conversion helpers of the port."""
