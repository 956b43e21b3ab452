"""Core helpers: errors, the id-dtype policy, and device resolution."""
