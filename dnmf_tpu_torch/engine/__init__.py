"""User-facing driver."""
