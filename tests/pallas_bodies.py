"""Run a Pallas kernel body of the JAX package eagerly, outside pallas_call.

A body reads its inputs and writes its outputs through refs. `Ref`
stands in for one: indexing reads a jnp array, and assignment replaces
it with `.at[key].set(value)`. The bodies make no `pl.*` call, so they
run as plain jnp code, one op at a time, without interpret mode and
without tracing the whole body: on the CPU that is the cheapest way to
get their outputs. Outputs start as zeros, so rows a body never writes
(rows 20..31 of each 32-row coordinate slot) read 0, as the port's plain
versions write them.
"""

import jax.numpy as jnp
import numpy as np


class Ref:
    def __init__(self, value):
        self.value = jnp.asarray(value)

    @property
    def shape(self):
        return self.value.shape

    def __getitem__(self, key):
        return self.value[key]

    def __setitem__(self, key, v):
        self.value = self.value.at[key].set(v)


def run_body(body, inputs, out_rows):
    """body(*input refs, *output refs) -> the outputs as numpy arrays.
    Outputs are (rows, n) int32, n the last axis of the first input."""
    n = np.shape(inputs[0])[-1]
    outs = [Ref(jnp.zeros((rows, n), dtype=jnp.int32)) for rows in out_rows]
    body(*(Ref(x) for x in inputs), *outs)
    return [np.asarray(o.value) for o in outs]
