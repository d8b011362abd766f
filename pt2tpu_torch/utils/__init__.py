"""Artifacts, random models and device selection."""
