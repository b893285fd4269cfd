"""Host-side utilities of the port: the op counter of the planning tools."""
