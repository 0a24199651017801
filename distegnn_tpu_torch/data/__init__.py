"""Datasets and loaders (port of the single-device part of
``distegnn_tpu/data``)."""
