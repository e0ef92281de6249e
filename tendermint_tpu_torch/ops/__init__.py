"""Device engine of the port: columnar batches, the plain PyTorch field and
point arithmetic, the RLC kernels and their wrappers, the batch verifier
(counterpart: tendermint_tpu/ops/)."""
