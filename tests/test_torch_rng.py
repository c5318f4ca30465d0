"""Counter RNG of the torch port: bitwise equal to the JAX package's RNG,
under NumPy and under jax.numpy."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbr_tpu.ops import rng as R
from pbr_tpu_torch.ops import rng as T

# The suite runs in parallel worker processes; torch's default of one
# thread per core in each of them oversubscribes the machine (measured: a
# 3 s test took 180 s with four workers).
torch.set_num_threads(1)

IDS = np.random.default_rng(0).integers(0, 1 << 22, size=2048).astype(np.int32)


@pytest.mark.parametrize(
    "seed,sample,bounce,stream",
    list(itertools.product((0, 7, 0xFFFFFFFF), (0, 3), (0, 5), (R.S_AA_R, R.S_BRDF_B, R.S_RR))),
)
def test_uniform_bitwise(seed, sample, bounce, stream):
    ref = R.uniform(seed, IDS.astype(np.uint32), sample, bounce, stream)
    got = T.uniform(seed, torch.as_tensor(IDS), sample, bounce, stream)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    jx = R.uniform(jnp.uint32(seed), jnp.asarray(IDS.astype(np.uint32)), sample, bounce, stream)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx))


def test_stream_ids_match():
    names = [n for n in dir(R) if n.startswith("S_")]
    assert names
    for n in names:
        assert getattr(T, n) == getattr(R, n), n


@pytest.mark.parametrize("seed_as_tensor", [False, True])
def test_pixel_rng_at_u_bitwise(seed_as_tensor):
    seed = torch.tensor(123456789, dtype=torch.int64) if seed_as_tensor else 123456789
    ref = R.PixelRng(123456789, IDS.astype(np.uint32))
    got = T.PixelRng(seed, torch.as_tensor(IDS))
    for s, b in ((0, 0), (1, 4), (2, 7)):
        for stream in range(11):
            np.testing.assert_array_equal(got.at(s, b).u(stream).numpy(), ref.at(s, b).u(stream))
            np.testing.assert_array_equal(got.u(s, b, stream).numpy(), ref.u(s, b, stream))


def test_gather_rows_bitwise():
    ref = R.PixelRng(5, IDS.astype(np.uint32))
    got = T.PixelRng(5, torch.as_tensor(IDS))
    src = np.array([3, 0, 15, 7], dtype=np.int32)
    r_ref = ref.gather_rows(src, 128)
    r_got = got.gather_rows(torch.as_tensor(src), 128)
    np.testing.assert_array_equal(r_got.u(0, 2, R.S_EXTEND).numpy(), r_ref.u(0, 2, R.S_EXTEND))


def test_negative_and_large_ids_wrap_like_uint32():
    ids = np.array([-1, -2**31, 2**31 - 1, 0], dtype=np.int32)
    ref = R.uniform(3, ids.astype(np.uint32), 0, 0, R.S_RR)
    got = T.uniform(3, torch.as_tensor(ids), 0, 0, R.S_RR)
    np.testing.assert_array_equal(got.numpy(), ref)
