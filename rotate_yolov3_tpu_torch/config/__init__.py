"""Darknet .cfg/.data parsing and the training hyperparameters."""
