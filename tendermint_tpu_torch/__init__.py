"""tendermint_tpu_torch — the PyTorch/CUDA port of tendermint_tpu's device engine.

This package carries `types.verify_commit` for an ed25519 commit end to
end on an NVIDIA H100: the commit's signatures are packed into RLC lanes
(M = 4 signatures per lane, ops/rlc.py) and verified by three CUDA
kernels written by hand for sm_90a (csrc/rlc.cu), with a plain PyTorch
version of each kernel beside it.

It imports torch and numpy, never jax and nothing of tendermint_tpu: the
JAX package stays in the repository as the reference, and the modules
here keep their own copies of what they need from it (each module names
its counterpart). Entry points take an explicit `device`; the default is
the CUDA card, and they raise when none is present (device.py).
"""
