"""Runtime utilities of the port."""
