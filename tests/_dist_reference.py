"""The reference package's routers at 1, 2 and 4 shards, on the inputs of
``tests/_dist_ranks.py``; run as a separate process with four host
devices::

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/_dist_reference.py OUT.npz

Writes every output under ``<n>/<case>/<name>``, the names of the rank
processes' outputs.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from _dist_ranks import chunk_inputs, router_inputs
from repro.jaxcompat import make_mesh, use_mesh
from repro.vector.distributed import (route_by_partition,
                                      route_partitioned_chunk)


def main(path: str) -> None:
    out = {}
    for n in (1, 2, 4):
        mesh = make_mesh((n,), ("data",), devices=jax.devices()[:n])
        r = {k: jnp.asarray(v) for k, v in router_inputs(n).items()}
        c = {k: jnp.asarray(v) for k, v in chunk_inputs(n).items()}
        # under jit: eager shard_map compiles anew on every call
        route = jax.jit(lambda *a, **kw: route_by_partition(mesh, *a, **kw))
        chunk = jax.jit(
            lambda *a: route_partitioned_chunk(mesh, *a))
        with use_mesh(mesh):
            res = {"route": route(r["events"], r["keys"],
                                  payload=r["payload"], drop=r["drop"]),
                   "route_plain": route(r["events"], r["keys"]),
                   "chunk": chunk(c["attrs"], c["keys"], c["positions"]),
                   "chunk_ts": chunk(c["attrs"], c["keys"], c["positions"],
                                     c["ts"])}
        names = {"route": ("routed", "payload", "keep"),
                 "route_plain": ("routed", "keep"),
                 "chunk": ("attrs", "keys", "positions", "valid", "keep"),
                 "chunk_ts": ("attrs", "keys", "positions", "ts", "valid",
                              "keep")}
        for case, vals in res.items():
            for name, v in zip(names[case], vals):
                out[f"{n}/{case}/{name}"] = np.asarray(v)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
