"""Hand-written Hopper kernels of the port, their plain versions and the
dispatch layer.  Nothing here builds or imports a compiler at import
time: ``build.py`` compiles the CUDA sources at first launch."""
