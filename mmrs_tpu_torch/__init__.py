"""mmrs_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of mmrs_tpu.

The module layout mirrors `mmrs_tpu/`, so each counterpart sits at the same
relative path. The search main path runs here: uint8 pixels -> fused
normalize (Triton) -> ViT towers whose attention is a hand-written CUDA
kernel -> L2-normalized gallery -> fused cosine top-k (CUDA) -> F1-optimal
threshold calibration; and the quantized serving path: int8 / int4
galleries scanned by their own top-k kernels (CUDA), and the int8 image
tower whose MLP is a fused int8 kernel (CUDA). Every op with a kernel
dispatches on the device of its input: a CPU tensor takes the plain
PyTorch version, a CUDA tensor the kernel (which is built from `csrc/` on
first use).

Importing this package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"
