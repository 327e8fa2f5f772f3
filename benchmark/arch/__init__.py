"""One module an architecture: the program it builds, its reference and its counts."""
