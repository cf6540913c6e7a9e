"""Measurement scripts for the port, run on a CUDA card from the repo
root (``python3 -m mxnet_tpu_torch.tools.<name>``)."""
