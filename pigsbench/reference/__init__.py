"""The plain reference: plain PyTorch, float64, frozen copies of the
formulas; it imports nothing of the program."""
