"""Plain references: the published models' forwards in float32 PyTorch,
the letterbox and the perceptual hashes in NumPy and PIL, and the tag
query's semantics in NumPy. Nothing here imports the port or JAX; every
input is the harness's own (weights, pictures, postings)."""
