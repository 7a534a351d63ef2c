"""The plain reference: line sum, column radiative transfer and the
radiative-convective sweep in plain PyTorch, independent of the program."""
