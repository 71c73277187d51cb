"""Host data for the port: synthetic raw batches (the dataset reader is not ported yet)."""
