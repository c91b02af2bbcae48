"""The dense decoder LM of the serving path (``lm``, ``blocks``,
``layers``), its parameter names and shapes, random init and weight
carry-across from the JAX package (``params``)."""
