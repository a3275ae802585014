"""Device selection, padding, timing and synthetic frames."""
