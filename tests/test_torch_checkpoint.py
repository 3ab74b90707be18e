"""Map checkpoints across the two packages on the CPU, on the constructed
map of ``tests/test_aux.py::TestCheckpoint::test_map_roundtrip`` (random
points, some valid, three keyframes) with seeded descriptor words that use
all 32 bits.

A map the reference saved loads in the port equal, field by field, to
``convert.map_state_from_numpy`` of it; a map the port saved loads in the
reference equal to the reference's map; the port's own round trip is the
identity (dtype, shape and values; the counters stay 0-d int32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.models import map_state as jms
from orbslam2_tpu.utils import checkpoint as jckpt
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.models.map_state import MapState
from orbslam2_tpu_torch.utils import checkpoint
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def ref_map(rng):
    m = jms.make_empty_map(8, 64, 32)
    return m._replace(
        pt_pos=jnp.asarray(rng.normal(size=(64, 3)), jnp.float32),
        pt_valid=jnp.asarray(rng.uniform(size=64) > 0.5),
        kf_desc=jnp.asarray(rng.integers(0, 2**32, (8, 32, 8), dtype=np.uint32)),
        pt_desc=jnp.asarray(rng.integers(0, 2**32, (64, 8), dtype=np.uint32)),
        kf_valid=jnp.asarray(np.arange(8) < 3),
        n_kf=jnp.int32(3),
        n_pt=jnp.int32(29),
    )


def _assert_maps_equal(a: MapState, b: MapState):
    for name in MapState._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), name


def test_reference_map_loads_in_the_port(ref_map, tmp_path):
    path = str(tmp_path / "ref.npz")
    jckpt.save_map(ref_map, path)
    loaded = checkpoint.load_map(path, "cpu")
    want = convert.map_state_from_numpy({k: np.asarray(v) for k, v in ref_map._asdict().items()},
                                        "cpu")
    _assert_maps_equal(loaded, want)
    assert loaded.kf_desc.dtype == torch.int32 and loaded.n_kf.shape == ()
    assert loaded.n_kf.dtype == torch.int32 and int(loaded.n_kf) == 3 and int(loaded.n_pt) == 29


def test_port_map_loads_in_the_reference(ref_map, tmp_path):
    port = convert.map_state_from_numpy({k: np.asarray(v) for k, v in ref_map._asdict().items()},
                                        "cpu")
    path = str(tmp_path / "port.npz")
    checkpoint.save_map(port, path)
    loaded = jckpt.load_map(path)
    for name in jms.MapState._fields:
        x, y = np.asarray(getattr(ref_map, name)), np.asarray(getattr(loaded, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    with np.load(path) as z:
        assert z["kf_desc"].dtype == np.uint32 and z["n_kf"].shape == ()


def test_port_round_trip_is_the_identity(ref_map, tmp_path):
    port = convert.map_state_from_numpy({k: np.asarray(v) for k, v in ref_map._asdict().items()},
                                        "cpu")
    path = str(tmp_path / "map.npz")
    checkpoint.save_map(port, path)
    _assert_maps_equal(checkpoint.load_map(path, "cpu"), port)


def test_load_map_takes_a_device():
    import inspect

    param = inspect.signature(checkpoint.load_map).parameters["device"]
    assert param.default is inspect.Parameter.empty
