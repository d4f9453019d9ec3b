"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

  label_intersect : batched hop-label intersection with the row gather fused
                    in (replaces ``repro.kernels.label_intersect``'s Pallas
                    kernel; the serve engine's ``kernel`` backend)
  frontier_expand : one BFS level of the device wave build, pushed from the
                    rows the last level reached (K2's frontier form; replaces
                    ``repro.kernels.frontier_ell`` on the build's path)
  frontier_or     : one BFS level over an ELL slab (K2's slab form, the
                    counterpart of ``repro.kernels.ops.frontier_or``; no
                    build path calls it)
  bitset_mm, flash_attention, ell_spmm, embedding_bag
                  : the kernel library, the counterpart of
                    ``repro.kernels.ops``; no oracle path calls them

``ops`` holds the wrappers (kernel on CUDA tensors, plain version on CPU
tensors, launch counts), ``ref`` the plain versions, ``build`` the ``nvcc``
build and ``ctypes`` loading of ``csrc/*.cu``.
"""
