"""Training engines of the port: the 1F1B pipeline (``pipeline.py``), the
LM trainer (``trainer.py``), checkpoints (``checkpoint.py``), fault
tolerance (``fault.py``) and the elastic runtime (``elastic.py``)."""
