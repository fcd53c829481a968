"""Device work to the part of the step it belongs to.

A kernel launched by a convolution operator (``aten::cudnn_convolution``,
``aten::convolution_backward``, ...) is a convolution whatever cuDNN
names it: its implicit GEMMs, the plain GEMMs it picks for 1x1 filters
and its layout passes.  Without that operator, the kernel's name
decides, by the kernel-name groups of ``chip_smoke.py``'s ``_GROUPS``:
the first group one of whose fragments the lower-cased name contains
wins, the rest is "other".  A convolution is named only by cuDNN's own
markers: cuBLAS's ``sm80_xmma_gemm_*`` products (the align-corners
resizes) are matrix products."""

GROUPS = (("ce_kernels", ("nll_fwd", "nll_bwd")),
          ("convolution", ("conv", "implicit", "fprop", "dgrad", "wgrad",
                           "cudnn", "winograd")),
          ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
          ("copy_layout", ("copy", "transpose", "permute", "cat")),
          ("reduction", ("reduce", "softmax", "norm", "sum", "max", "argm")),
          ("elementwise", ("elementwise", "vectorized", "where", "fill")))


def group_of(name, op=None):
    """The group of a kernel ``name`` launched inside the host operator
    ``op`` (None: not known)."""
    if op and "convolution" in op.lower():
        return "convolution"
    low = name.lower()
    return next((g for g, frags in GROUPS if any(f in low for f in frags)),
                "other")
