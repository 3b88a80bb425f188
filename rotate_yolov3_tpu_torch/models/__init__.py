"""Darknet network, .weights IO and the rotated YOLO head."""
