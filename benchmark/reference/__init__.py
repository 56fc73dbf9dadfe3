"""The plain reference the benchmark holds the port against (see `model.py`)."""
