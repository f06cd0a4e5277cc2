"""Scan and sort primitives of the torch port against the JAX package, on
the same numpy inputs; integer outputs, so the tolerance is exact
equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repkiller_tpu.utils import scan as jscan
from repkiller_tpu_torch.utils import scan as tscan
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("spread", ["ties", "wide"])
@pytest.mark.parametrize("n_keys", [1, 2, 3, 5, 8, 11])
def test_lexsort_matches_lax_sort(n_keys, spread):
    """Signed keys, many ties (or none), and a payload that shows the
    stability of rows whose keys are all equal."""
    rng = np.random.default_rng(10 * n_keys + (spread == "wide"))
    n = 600
    if spread == "ties":
        keys = [rng.integers(-2, 3, n).astype(np.int32) for _ in range(n_keys)]
    else:
        keys = [rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
                for _ in range(n_keys)]
        keys[0][:50] = keys[0][50:100]               # ties on the first key
    payload = np.arange(n, dtype=np.int32)
    want = jax.lax.sort(tuple(map(jnp.asarray, keys + [payload])),
                        num_keys=n_keys)
    perm = tscan.lexsort([torch.from_numpy(k) for k in keys]).numpy()
    for w, a in zip(want, keys + [payload]):
        assert np.array_equal(np.asarray(w), a[perm])


def test_lexsort_bool_and_int64_keys():
    rng = np.random.default_rng(3)
    n = 300
    flag = rng.random(n) < 0.5
    big = rng.integers(0, 2**32, n).astype(np.int64)   # uint32 values in int64
    small = rng.integers(-5, 5, n).astype(np.int32)
    want = jax.lax.sort((jnp.asarray(flag.astype(np.int32)),
                         jnp.asarray(big.astype(np.uint32)),
                         jnp.asarray(small), jnp.arange(n)), num_keys=3)
    perm = tscan.lexsort([torch.from_numpy(flag), torch.from_numpy(big),
                          torch.from_numpy(small)]).numpy()
    assert np.array_equal(np.asarray(want[3]), np.arange(n)[perm])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_cummax(seed):
    rng = np.random.default_rng(seed)
    n = 1000
    values = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    values[rng.random(n) < 0.1] = tscan.NEG_INF32
    boundary = rng.random(n) < 0.05 * (seed + 1)
    boundary[0] = True
    want = jscan.segmented_cummax(jnp.asarray(values), jnp.asarray(boundary))
    got = tscan.segmented_cummax(torch.from_numpy(values),
                                 torch.from_numpy(boundary))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p_live", [0.0, 0.3, 1.0])
def test_partition_live(p_live):
    rng = np.random.default_rng(int(p_live * 10))
    flag = rng.random(777) < p_live
    w_order, w_dest, w_n = jscan.partition_live(jnp.asarray(flag))
    order, dest, n_live = tscan.partition_live(torch.from_numpy(flag))
    assert np.array_equal(order.numpy(), np.asarray(w_order))
    assert np.array_equal(dest.numpy(), np.asarray(w_dest))
    assert int(n_live) == int(w_n) == flag.sum()


def test_prefix_in_segment():
    rng = np.random.default_rng(5)
    values = rng.integers(-100, 100, 500).astype(np.int32)
    boundary = rng.random(500) < 0.1
    boundary[0] = True
    incl = jscan.segmented_cummax(jnp.asarray(values), jnp.asarray(boundary))
    want = jscan.prefix_in_segment(incl, jnp.asarray(boundary), jscan.NEG_INF32)
    got = tscan.prefix_in_segment(torch.from_numpy(np.array(incl)),
                                  torch.from_numpy(boundary), tscan.NEG_INF32)
    assert np.array_equal(got.numpy(), np.asarray(want))
