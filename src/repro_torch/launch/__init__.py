"""Entry points of the port's LM stack: serving (``serve.py``) and training
(``train.py``); and the launch tooling: the production meshes
(``mesh.py``), the assigned shapes (``shapes.py``), the dry run
(``dryrun.py``) and its roofline (``roofline.py``)."""
