"""Batched embedding inference."""
