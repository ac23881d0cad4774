"""Feature tables of the port: the chord embedding tables of
``chord2vec`` (a copy of the JAX package's features/chord2vec.py)."""
