"""Letterbox, inference input iterators, the training dataset and its
augmentation, the synthetic dataset writer and the DOTA tool chain."""
