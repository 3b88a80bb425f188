"""Drawing helpers."""
