"""Darknet network (fused inference and trainable), checkpoint IO and the
rotated YOLO head."""
