"""Carrying parameters across from the reference package."""
