"""The plain reference the benchmark holds the program to: host Python and numpy only."""
