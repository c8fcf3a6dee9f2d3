"""Utilities: logging and the noise source."""
