"""Multi-rank execution on ``torch.distributed`` (``mesh.py``)."""
