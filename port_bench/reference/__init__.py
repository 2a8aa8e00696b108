"""The plain reference: float32 PyTorch, written from the models' descriptions;
it imports nothing of the program."""
