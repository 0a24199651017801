"""Small helpers (port of ``distegnn_tpu/utils``)."""
