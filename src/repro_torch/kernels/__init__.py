"""Hand-written Hopper kernels of the port: each `<name>/` package holds the
wrapper that launches the CUDA kernel of `csrc/`, its plain PyTorch version
(`ref.py`) and the public entry point; `build.py` compiles and loads them."""
