"""Training runtime (port of the single-device part of
``distegnn_tpu/train``): losses, the train and eval steps, checkpoints and
the epoch loop."""
