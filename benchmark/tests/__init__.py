"""CPU tests of the benchmark (the card-only ones skip without a card)."""
