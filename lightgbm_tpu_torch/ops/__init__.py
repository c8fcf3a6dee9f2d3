"""Device operators: histogram and compaction kernels, split search,
binned forest traversal."""
