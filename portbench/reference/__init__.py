"""Plain PyTorch references that judge the port's outputs.  Nothing
here imports the port, JAX or the JAX package."""
