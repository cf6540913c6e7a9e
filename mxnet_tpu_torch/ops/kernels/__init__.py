"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its wrapper,
its plain PyTorch version and its launch counter.

| kernel | replaces (TPU) |
| --- | --- |
| ``flash_attention`` | ``mxnet_tpu/ops/pallas/flash_attention.py`` ``_fa_forward`` |
"""
