"""Host-side audio I/O, file discovery and the synthetic corpus (numpy/scipy)."""
