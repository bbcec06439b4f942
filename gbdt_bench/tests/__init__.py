"""CPU tests of the benchmark (and one card test, marked gpu)."""
