"""Training: the train step and loop (``loop.py``), straggler detection
(``straggler.py``) and single-device recovery (``elastic.py``), as in
``repro.train``."""
