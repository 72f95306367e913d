"""Synthetic data for the port's training path."""
