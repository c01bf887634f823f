"""CPU tests of the benchmark harness and its reference."""
