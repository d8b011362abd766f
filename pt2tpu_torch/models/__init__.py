"""Llama-family decoder, shared blocks and configs."""
