"""Sharded checkpoints whose writer takes the paper's three knobs, and the
tuner that picks them from the save log (``ckpt.py``, ``tuning.py``)."""
