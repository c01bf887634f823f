"""Hand-written CUDA kernels of the port (built on first use, see ``build``)."""
