"""Optimizer configuration, codes and state (torch port)."""
