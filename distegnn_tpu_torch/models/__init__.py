"""Model families of the port (FastEGNN so far)."""
