"""Operators of the port: plain PyTorch math and the hand-written kernels
(``ops/kernels``) that replace the reference's Pallas kernels."""
