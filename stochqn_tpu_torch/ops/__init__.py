"""Two-loop direction and pair commits (torch port)."""
