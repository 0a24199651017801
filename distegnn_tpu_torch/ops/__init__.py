"""Graph layout, neighbour search and the fused edge kernel."""
