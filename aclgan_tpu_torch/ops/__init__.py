"""Op and block layer (NCHW)."""
