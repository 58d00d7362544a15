"""The host input pipeline with the paper's three knobs (``pipeline.py``)."""
