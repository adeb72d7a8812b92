"""Host data: datasets and loaders (numpy only)."""
