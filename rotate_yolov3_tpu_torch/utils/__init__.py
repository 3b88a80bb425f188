"""Drawing helpers and the training-metrics writer."""
