"""The plain reference the benchmark decides ``correct`` against; it
imports nothing of the program."""
