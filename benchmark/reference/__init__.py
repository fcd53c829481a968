"""The plain reference: the algorithm of each cell in plain PyTorch.

It imports nothing of ``dasac_tpu_torch``, of JAX or of ``dasac_tpu``.  The
augmentation, the SAC core and the refine are frozen copies of the port's
(``aug/``, ``sac/``), cut to the paths the cells run, with the
height sharding, the process groups and the CUDA CE kernels left out; the
models are written from the published layer equations with the module
names of the reference torch code, so one state dict loads into both
sides.  Each computes in a :class:`layers.Precision`: float32 (TF32 off)
for the reference, bf16 with fp8-rounded convolution operands for the
control.
"""
