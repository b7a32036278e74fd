"""Data pipeline and tokenizer of the port's training path."""
