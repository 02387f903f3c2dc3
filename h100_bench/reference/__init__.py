"""Plain float32 PyTorch references, one module a configuration, named as
the configuration; they import nothing of the program under test."""
