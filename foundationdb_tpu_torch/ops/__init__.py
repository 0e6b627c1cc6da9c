"""Device ops: digests, searches, scans and range-max (plain + CUDA)."""
