"""Detect -> crop -> pose serving pipeline."""
