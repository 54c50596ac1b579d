"""Compile-friendly 1-D prefix scans.

A length-N 1-D associative scan can lower to a network whose compile time
grows superlinearly with N. The standard two-level decomposition bounds the
network to one row length, with identical results:

  1. reshape [N] -> [R, C] and scan each row (axis=1) — a C-length network;
  2. scan the R row-totals (a tiny 1-D scan);
  3. combine each row's elements with the exclusive row-prefix.

Works for any associative op over pytrees of equally-shaped arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_CHUNK = 1024


def _pad_rows(x, pad, fill):
    return jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)]) if pad else x


def assoc_scan_1d(fn, xs, identity):
    """Inclusive associative scan of a pytree of 1-D arrays.

    fn(a, b) combines two pytrees elementwise (b is "later"); identity is a
    pytree of neutral fill values used for padding (must satisfy
    fn(x, identity-elements-on-the-right-pad) never being read back —
    padding sits at the END so it never influences real prefixes).
    """
    leaves, treedef = jax.tree_util.tree_flatten(xs)
    n = leaves[0].shape[0]
    if n <= 2 * _CHUNK:
        return jax.lax.associative_scan(fn, xs)
    C = _CHUNK
    R = -(-n // C)
    pad = R * C - n
    id_leaves = jax.tree_util.tree_leaves(identity)
    rows = treedef.unflatten([
        _pad_rows(l, pad, f).reshape(R, C) for l, f in zip(leaves, id_leaves)])
    # 1. per-row inclusive scan
    row_scan = jax.lax.associative_scan(fn, rows, axis=1)
    # 2. exclusive prefix of the row totals (last column), shifted by one row
    totals = jax.tree_util.tree_map(lambda a: a[:, -1], row_scan)
    tot_scan = jax.lax.associative_scan(fn, totals)
    shift = jax.tree_util.tree_map(
        lambda a, f: jnp.concatenate(
            [jnp.full((1,), f, a.dtype), a[:-1]]),
        tot_scan, treedef.unflatten(list(id_leaves)))
    # 3. combine: prefix row-carry with each element
    out = fn(jax.tree_util.tree_map(lambda a: a[:, None], shift), row_scan)
    return jax.tree_util.tree_map(lambda a: a.reshape(-1)[:n], out)


def cumsum_1d(x):
    """Inclusive cumsum of a 1-D array (two-level, compile-friendly)."""
    n = x.shape[0]
    if n <= 2 * _CHUNK:
        return jnp.cumsum(x)
    C = _CHUNK
    R = -(-n // C)
    pad = R * C - n
    rows = _pad_rows(x, pad, np.array(0, x.dtype)).reshape(R, C)
    row_scan = jnp.cumsum(rows, axis=1)
    totals = row_scan[:, -1]
    shift = jnp.concatenate(
        [jnp.zeros((1,), x.dtype), jnp.cumsum(totals)[:-1]])
    return (row_scan + shift[:, None]).reshape(-1)[:n]


def running_max_1d(x):
    """Inclusive running maximum of a 1-D array (two-level)."""
    n = x.shape[0]
    if n <= 2 * _CHUNK:
        return jax.lax.associative_scan(jnp.maximum, x)
    C = _CHUNK
    R = -(-n // C)
    pad = R * C - n
    fill = jnp.iinfo(x.dtype).min if jnp.issubdtype(x.dtype, jnp.integer) \
        else -jnp.inf
    rows = _pad_rows(x, pad, fill).reshape(R, C)
    row_scan = jax.lax.associative_scan(jnp.maximum, rows, axis=1)
    totals = row_scan[:, -1]
    shift = jnp.concatenate(
        [jnp.full((1,), fill, x.dtype),
         jax.lax.associative_scan(jnp.maximum, totals)[:-1]])
    return jnp.maximum(row_scan, shift[:, None]).reshape(-1)[:n]
