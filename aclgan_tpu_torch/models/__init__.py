"""Networks."""
