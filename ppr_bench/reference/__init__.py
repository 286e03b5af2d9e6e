"""The plain reference the benchmark checks the program against: plain
PyTorch, importing nothing of the program under test."""
