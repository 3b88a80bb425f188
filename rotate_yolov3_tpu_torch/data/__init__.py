"""Letterbox, inference input iterators and the DOTA tool chain."""
