"""Loading trained experiments and serving them."""
