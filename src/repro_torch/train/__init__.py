"""Training engines of the port: the 1F1B pipeline (``pipeline.py``)."""
