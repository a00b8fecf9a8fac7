"""Weight synthesis and precision settings."""
