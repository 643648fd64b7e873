"""Configuration defaults for the port."""
