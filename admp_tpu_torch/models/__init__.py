"""Multipolar PME force models."""
