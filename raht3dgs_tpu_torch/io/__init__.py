"""Point-cloud file I/O."""
