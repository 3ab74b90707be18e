"""K2 parity: the port's Hamming matrix (the CPU side of csrc/hamming.cu)
and the matching built on it, against the JAX reference.

Tolerance: exact — distances, indices and accept masks are integers and
booleans.  On the CPU the reference's ``hamming_matrix`` is its XLA path
(the Pallas entry point has no interpret flag).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import hamming as jh
from orbslam2_tpu_torch.ops import hamming as th
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _near_copies(rng, base, n, flips):
    """Descriptors that are ``base`` rows with a few bits flipped, so that
    matching has real nearest neighbours and ties."""
    idx = rng.integers(0, base.shape[0], n)
    out = base[idx].copy()
    for r in range(n):
        for _ in range(rng.integers(0, flips)):
            w, b = rng.integers(0, 8), rng.integers(0, 32)
            out[r, w] ^= np.uint32(1 << int(b))
    return out


@pytest.mark.parametrize("na, nb", [(1, 1), (7, 130), (128, 128), (300, 257)])
def test_hamming_matrix_exact(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    a, b = _desc(rng, na), _desc(rng, nb)
    a[0] = 0xFFFFFFFF  # all bits set, and the sign bit of the int32 view
    ref = np.asarray(jh.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    out = th.hamming_matrix(_t(a), _t(b)).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_best2_exact(with_mask):
    rng = np.random.default_rng(7)
    base = _desc(rng, 64)
    a, b = _near_copies(rng, base, 200, 12), _near_copies(rng, base, 150, 12)
    dist = np.array(jh.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    mask = rng.uniform(size=dist.shape) > 0.5 if with_mask else None
    ref = jh.masked_best2(jnp.asarray(dist), None if mask is None else jnp.asarray(mask))
    out = th.masked_best2(torch.from_numpy(dist), None if mask is None else torch.from_numpy(mask))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("cross_check, ratio, max_dist", [
    (True, 0.7, jh.TH_LOW), (False, 0.9, jh.TH_HIGH), (True, 1.0, jh.TH_HIGH),
])
def test_match_descriptors_exact(cross_check, ratio, max_dist):
    rng = np.random.default_rng(11)
    base = _desc(rng, 80)
    a, b = _near_copies(rng, base, 256, 20), _near_copies(rng, base, 200, 20)
    va, vb = rng.uniform(size=256) > 0.1, rng.uniform(size=200) > 0.1
    pm = rng.uniform(size=(256, 200)) > 0.3
    ref = jh.match_descriptors(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                               jnp.asarray(vb), pair_mask=jnp.asarray(pm),
                               max_dist=max_dist, ratio=ratio, cross_check=cross_check)
    out = th.match_descriptors(_t(a), torch.from_numpy(va), _t(b), torch.from_numpy(vb),
                               pair_mask=torch.from_numpy(pm), max_dist=max_dist,
                               ratio=ratio, cross_check=cross_check)
    for name in ("idx", "dist", "dist2", "ok"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
    assert np.asarray(ref.ok).sum() > 10


def test_rotation_consistency_exact():
    rng = np.random.default_rng(5)
    ang_a = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 250).astype(np.float32)
    idx = rng.integers(0, 250, 300).astype(np.int32)
    # A dominant rotation plus clutter, like a real match set.
    ang_b[idx[:200]] = (ang_a[:200] - 0.4 + rng.normal(0, 0.05, 200)).astype(np.float32)
    ok = rng.uniform(size=300) > 0.2
    ref = jh.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(idx),
                                  jnp.asarray(ok))
    out = th.rotation_consistency(torch.from_numpy(ang_a), torch.from_numpy(ang_b),
                                  torch.from_numpy(idx).long(), torch.from_numpy(ok))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
