"""Darknet .cfg/.data parsing."""
