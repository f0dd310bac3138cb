"""Host-side audio I/O, file discovery, segment datasets and batch
loaders, corpus statistics files and the synthetic corpus (numpy/scipy)."""
