"""Hand-written Hopper kernels of the weight-transfer path.

* ``checksum`` — end-to-end transfer integrity (paper 4.6).
* ``quant``    — int8 row quantization for the ``int8`` and ``delta:int8``
  wire codecs.

Each module holds the wrapper (launches the CUDA kernel on a CUDA tensor,
runs the plain PyTorch version on a CPU tensor), the plain version, and a
launch counter. The CUDA sources live in ``csrc/`` and are built at first
use by :mod:`repro_torch.kernels.build`.
"""
