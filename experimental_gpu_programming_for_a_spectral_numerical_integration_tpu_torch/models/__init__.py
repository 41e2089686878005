"""Rod models of the port."""
