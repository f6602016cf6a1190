"""Motion models of the port."""
