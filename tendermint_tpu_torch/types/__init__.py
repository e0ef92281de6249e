"""Chain data types and commit verification (counterpart:
tendermint_tpu/types/)."""
