"""Small libraries of the port (counterpart: tendermint_tpu/libs)."""
