"""Inference-prep layout transforms."""
