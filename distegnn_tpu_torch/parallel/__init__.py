"""Cross-partition reductions (single-device form so far)."""
