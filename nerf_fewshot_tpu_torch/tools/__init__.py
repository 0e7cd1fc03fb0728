"""Scripts that measure the port on the card (run as files, not imported)."""
