"""The least work of a kernel or of an iteration, from its shapes."""
