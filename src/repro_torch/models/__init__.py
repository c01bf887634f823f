"""Model code of the port (GQA transformer path)."""
