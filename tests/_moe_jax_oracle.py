"""The JAX package's expert-parallel MoE paths on a device mesh, for
``test_torch_moe.py``: run as a script in a process of its own with four
host devices (``--xla_force_host_platform_device_count=4``), it writes one
npz of every case's parameters, outputs, aux and gradients of ``sum(y *
w) + aux``.  The cases and their inputs come from :data:`CASES` and
:func:`inputs`, which the test and ``_moe_pg_worker.py`` share (numpy
only)."""

import os
import sys
import zlib

import numpy as np

# name -> (SP degree, pods, experts, experts a token, capacity factor,
# shared experts).  6 experts over 2 x 2 ranks divide the inner axis but
# not the SP degree: the "model"-axis branch.
CASES = {
    "p2": (2, 1, 8, 2, 1.0, 0),
    "p4": (4, 1, 8, 2, 1.0, 0),
    "p4_nodrop": (4, 1, 8, 2, 8.0, 0),
    "pods2x2_e6": (4, 2, 6, 2, 1.0, 1),
}
D_MODEL, D_FF = 32, 16
A2A_SHAPE = (2, 32)  # (B, S): S divides by every SP degree
DECODE_SHAPE = (3, 1)  # one token a row: the replicated-sequence path


def moe_config(cls, case):
    """The ArchConfig (``cls``: the JAX one or the port's) of a case."""
    _, _, E, K, cf, shared = CASES[case]
    return cls(name="moe-ep", family="moe", n_layers=1, d_model=D_MODEL, n_heads=4,
               n_kv_heads=4, d_ff=D_FF, vocab_size=64, n_experts=E, n_experts_per_token=K,
               moe_d_ff=D_FF, n_shared_experts=shared, capacity_factor=cf, dtype="float32",
               param_dtype="float32")


def inputs(case, kind):
    """``(x, w)`` of a case, ``kind`` "a2a" or "decode"."""
    B, S = A2A_SHAPE if kind == "a2a" else DECODE_SHAPE
    rng = np.random.default_rng(zlib.crc32(f"{case}/{kind}".encode()))
    x = rng.standard_normal((B, S, D_MODEL)).astype(np.float32)
    w = rng.standard_normal((B, S, D_MODEL)).astype(np.float32)
    return x, w


def _path(keys):
    """A JAX key path as "a/b/c"."""
    return "/".join(k.key for k in keys)


def params_tree(npz, prefix):
    """The nested dict of numpy leaves stored under ``prefix`` (paths as
    :func:`flat_leaves` writes them)."""
    tree = {}
    for key in npz.files:
        if key.startswith(prefix):
            path = key[len(prefix):].split("/")
            node = tree
            for name in path[:-1]:
                node = node.setdefault(name, {})
            node[path[-1]] = npz[key]
    return tree


def flat_leaves(tree, prefix=""):
    """``(path, leaf)`` of a nested dict, paths joined by "/"."""
    out = []
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        out += flat_leaves(sub, name + "/") if isinstance(sub, dict) else [(name, sub)]
    return out


def main(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.core.api import ParallelContext
    from repro.models.config import ArchConfig
    from repro.models.moe import moe_ffn, moe_init

    res = {}
    for case, (P, pods, *_) in CASES.items():
        cfg = moe_config(ArchConfig, case)
        devs = np.array(jax.devices()[:P])
        if pods > 1:
            mesh = Mesh(devs.reshape(1, pods, P // pods), ("data", "pod", "model"))
            sp_axes = ("pod", "model")
        else:
            mesh = Mesh(devs.reshape(1, P), ("data", "model"))
            sp_axes = ("model",)
        pctx = ParallelContext(mesh=mesh, sp_axes=sp_axes, impl="xla")
        p = moe_init(jax.random.PRNGKey(len(case)), cfg)
        for name, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            res[f"{case}/param/{_path(name)}"] = np.asarray(leaf)
        for kind in ("a2a", "decode"):
            x, w = inputs(case, kind)

            def loss(p, x, w=w):
                y, aux = moe_ffn(p, x, cfg, pctx)
                return jnp.sum(y * w) + aux, (y, aux)

            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
            res[f"{case}/{kind}/y"] = np.asarray(y)
            res[f"{case}/{kind}/aux"] = np.asarray(aux)
            res[f"{case}/{kind}/gx"] = np.asarray(gx)
            for name, leaf in jax.tree_util.tree_flatten_with_path(gp)[0]:
                res[f"{case}/{kind}/grad/{_path(name)}"] = np.asarray(leaf)
    np.savez(out, **res)
    print("ORACLE DONE")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1])
