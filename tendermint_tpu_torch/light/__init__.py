"""The light client (counterpart: tendermint_tpu/light/): header
verification (verifier.py), the trusted store (store.py), providers
(provider.py) and the client with bisection and the divergence detector
(client.py)."""
