"""Command-line tools of the port, run as ``python -m
rotate_yolov3_tpu_torch.tools.<name>``: ``kmeans_anchors`` (anchors from
dataset labels) and ``verify_reference`` (checks of the reference's
semantics against a checkout of it)."""
