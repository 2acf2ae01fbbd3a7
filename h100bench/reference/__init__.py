"""The plain reference that decides ``correct``: float32 PyTorch, nothing of
the program."""
