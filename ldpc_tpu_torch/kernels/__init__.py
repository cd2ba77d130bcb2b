"""Hand-written CUDA kernels of the port and their plain torch versions
(counterparts of `ldpc_tpu/kernels/`). Nothing here compiles or imports a
GPU toolchain on import; `build.load` runs nvcc at a kernel's first
launch."""
