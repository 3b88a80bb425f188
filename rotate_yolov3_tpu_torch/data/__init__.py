"""Letterbox and inference input iterators."""
