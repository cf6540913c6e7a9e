"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its wrapper,
its plain PyTorch version and its launch counter.

| wrapper | kernel source | replaces (TPU) |
| --- | --- | --- |
| ``flash_attention.flash_attention`` | ``flash_attention_fwd.cu`` | ``mxnet_tpu/ops/pallas/flash_attention.py`` ``_fa_forward`` |
| ``flash_attention.flash_attention_bwd`` | ``flash_attention_bwd.cu`` | ``flash_attention.py`` ``_fa_backward`` |
| ``fused_update.sgd_mom_update`` | ``fused_update.cu`` | ``mxnet_tpu/ops/pallas/fused_update.py`` ``sgd_mom_update`` |
| ``fused_update.adam_update`` | ``fused_update.cu`` | ``fused_update.py`` ``adam_update`` |
| ``conv_wgrad.conv_wgrad`` / ``conv_wgrad.wgrad`` | ``conv_wgrad.cu`` | ``mxnet_tpu/ops/pallas/conv_bwd.py`` ``conv_wgrad`` |
| ``lstm.lstm_step`` | ``lstm_step.cu`` | ``mxnet_tpu/ops/pallas/lstm.py`` ``lstm_step`` |
"""
