"""Entry points of the port's LM stack: serving (``serve.py``) and training
(``train.py``)."""
