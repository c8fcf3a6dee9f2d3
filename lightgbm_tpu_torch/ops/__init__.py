"""Device operators: histogram, compaction and partition-move kernels,
the histogram probe kernels, split search, binned forest traversal."""
