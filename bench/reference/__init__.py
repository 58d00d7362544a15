"""Plain float32 references of the served model families, one module each
(``hybrid``, ``dense``), with their shared layers in ``layers``.  They import
neither JAX nor any part of the program under test: they take the weights
and tokens the benchmark made and the configuration's sizes, and work out
the logits and the decode state themselves."""
