"""Schedules, streaming ingestion and observability helpers."""
