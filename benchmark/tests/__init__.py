"""CPU tests of the benchmark (and, marked ``chip``, its runs on a card)."""
