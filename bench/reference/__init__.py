"""The plain reference the benchmark holds the measured package to: plain
torch and numpy, importing nothing of the measured package."""
