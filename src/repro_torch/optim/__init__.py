"""Optimizer and LR schedules of the port's training path."""
