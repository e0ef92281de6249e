"""Wire encodings the port needs: proto3 and canonical vote sign-bytes
(counterpart: tendermint_tpu/wire/)."""
