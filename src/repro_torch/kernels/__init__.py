"""Hand-written Hopper kernels of the weight-transfer, serving and training paths.

* ``checksum`` — end-to-end transfer integrity (paper 4.6).
* ``quant``    — int8 row quantization for the ``int8`` and ``delta:int8``
  wire codecs; ``quant.fused``, the fused int8 dequantize + gather of a
  resharded int8 pull.
* ``repack``   — the byte gather of a resharded raw pull (staging runs
  into the destination unit).
* ``flash_attention`` — the attention of the decoder's prefill and decode
  (the serving path), and its backward (the training step).

Each module holds the wrapper (launches the CUDA kernel on a CUDA tensor,
runs the plain PyTorch version on a CPU tensor), the plain version, and a
launch counter. The CUDA sources live in ``csrc/`` and are built at first
use by :mod:`repro_torch.kernels.build`.
"""
