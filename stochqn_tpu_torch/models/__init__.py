"""Losses (torch port)."""
