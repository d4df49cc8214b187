"""Host C++ tools of the port (no CUDA)."""
