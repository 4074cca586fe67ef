"""Device operators of the port: tiling, the predicate/group-id kernel and
the segmented aggregation kernels (hand-written CUDA on a CUDA tile, plain
torch on a CPU tile)."""
