"""The light client (counterpart: tendermint_tpu/light/): header
verification (verifier.py), the trusted store (store.py), providers
(provider.py), the client with bisection and the divergence detector
(client.py), and the batched light service (batch.py, service.py) over
the device's dispatcher."""
