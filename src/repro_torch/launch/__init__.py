"""Launchers: serve."""
