"""Hand-written Hopper kernels with their plain PyTorch versions, and
the small tensor operators around them."""
