"""Model state and update steps."""
