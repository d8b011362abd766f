"""Packed ternary codec."""
