"""The port's mesh of ranks and its ambient context."""
