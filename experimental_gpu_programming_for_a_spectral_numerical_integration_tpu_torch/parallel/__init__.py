"""Multi-device rod batches (``mesh.py``)."""
