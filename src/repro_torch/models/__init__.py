"""Model definitions: the dense transformer of the serving slice."""
