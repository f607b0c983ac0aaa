"""Grid geometry."""
