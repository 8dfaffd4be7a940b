"""The plain reference of the output check: PyTorch and NumPy only, TF32 off.

It imports neither JAX, nor the reference package, nor anything of the
port, and takes nothing the port made: it gets the asset's arrays, the
weights and the crops the benchmark made from the seed, and recomputes the
rest (the stream's batches, the forward, the losses, the update).
"""
