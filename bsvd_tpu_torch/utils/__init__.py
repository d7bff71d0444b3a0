"""Registry of the port."""
