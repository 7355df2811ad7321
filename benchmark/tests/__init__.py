"""CPU tests of the benchmark (card tests skip without one)."""
