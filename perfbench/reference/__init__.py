"""MaGNet in plain PyTorch: the yardstick of ``correct``. Imports nothing
of the program, of JAX or of the JAX package."""
