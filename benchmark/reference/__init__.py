"""Plain references of the configurations, and what they share."""
