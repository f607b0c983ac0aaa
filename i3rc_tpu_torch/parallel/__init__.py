"""Batch statistics."""
