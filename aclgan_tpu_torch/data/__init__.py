"""Image transforms."""
