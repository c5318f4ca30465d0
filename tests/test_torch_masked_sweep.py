"""Kernel K5m, the masked row sweep (``cuda_sweep._masked_kernel`` and its
plain version ``_masked_plain``), on crafted passes: against the JAX
package's ``_kernel_masked_rows`` (``pbr_tpu/ops/pallas_sweep.py``, built by
``_build_call_masked`` and run in interpret mode, as tests/test_sweep.py
runs it on the CPU), called with the same lin tables, rays, verdict words
and seeds.

The passes hold what the kernel's every-warp deal must get right:
- rows partly gated: random verdict bits, some rows with none;
- an all-padding lin cluster (every coefficient 0: det = 0, t = NaN,
  never valid), gated in;
- equal t on two faces in different 16-face chunks (a warp takes faces
  [16 w, 16 w + 16) of a row): face 3's coefficients copied to face 40 of
  the same lin cluster and to face 5 of the next, with rays aimed at it,
  so the first face in memory order must win the tie;
- seeds that already win: dead lanes (t -3e38), a seed at half the ray's
  t, a seed at the ray's t with a face id one below and one above its
  face; any-hit lanes seeded occluded.

Tolerance: faces and the any-hit bits equal; t within rtol 1e-4 / atol
1e-5, that of tests/test_torch_row_sweep.py (XLA on the CPU may sum the
linear form's dot products in another order). The kernel runs only on a
card: the ``cuda``-marked test holds it bitwise to the plain version there
and skips here.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbr_tpu.ops.pallas_sweep as jax_sweep
from pbr_tpu.scene.procedural import random_soup
from pbr_tpu_torch.ops import cuda_sweep as cs
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.device import to_torch

torch.set_num_threads(1)

N_RAYS = 2 * cs.TILE
BIG_NEG = np.float32(-3.0e38)
TIE_FACE = 3  # copied to face 40 (another chunk) and to face 128 + 5 (another lin cluster)


@functools.lru_cache(maxsize=None)
def _case(seed):
    """(rays o, d as (3, N) float32, the (CL, 16, 128) lin table with the
    tie copies and an all-padding lin cluster, the verdict words, the live
    mask)."""
    scene, _ = scene_from_text(random_soup(300, seed=seed), use_bvh=True)
    ts = to_torch(scene, "cpu")
    lin = ts.clusters.lin.numpy().copy()
    lin[0, :, 40] = lin[0, :, TIE_FACE]
    lin[1, :, 5] = lin[0, :, TIE_FACE]
    lin = np.concatenate([lin, np.zeros((1, 16, cs.LIN), np.float32)])
    rng = np.random.default_rng(seed)
    v0, e1, e2 = (np.stack([c.numpy() for c in v]) for v in (ts.tris.v0, ts.tris.e1, ts.tris.e2))
    # Each ray aims at a point inside a face: the tie face for the first
    # 64 rays (rows 0 and 1 of tile 0), random faces for the rest.
    faces = np.where(np.arange(N_RAYS) < 64, TIE_FACE, rng.integers(0, 300, N_RAYS))
    a, b = rng.uniform(0.05, 0.45, (2, N_RAYS))
    target = v0[:, faces] + a * e1[:, faces] + b * e2[:, faces]
    o = rng.uniform(-1.5, 1.5, (3, N_RAYS)) + np.array([[0.0], [0.0], [3.0]])
    d = target - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    n_tiles, cl = N_RAYS // cs.TILE, lin.shape[0]
    bits = rng.random((n_tiles, cl, cs.GROUPS)) < 0.7
    bits[:, 0, :2] = True  # the tie face's rows run its lin clusters
    bits[:, 1, :2] = True
    bits[:, :, 7] = False  # a row with no lin cluster at all
    word = (bits * (1 << np.arange(cs.GROUPS))).sum(axis=2).astype(np.int32)
    if cl % 2:
        word = np.concatenate([word, np.zeros((n_tiles, 1), np.int32)], axis=1)
    words = word[:, 0::2] | (word[:, 1::2] << 8)
    live = np.arange(N_RAYS) % 7 != 3
    return o.astype(np.float32), d.astype(np.float32), lin, words.astype(np.int32), live


def _open_seeds(seed):
    """Nearest seeds that let every face win: +inf and face -1 on live
    lanes, -3e38 on dead ones."""
    live = _case(seed)[4]
    t0 = np.where(live, np.float32(np.inf), BIG_NEG).astype(np.float32)
    return t0, np.full(N_RAYS, -1, np.int32)


def _win_seeds(seed, t, f):
    """Seeds that already win or tie, from a nearest pass's own (t, f) with
    open seeds: a quarter of the hit lanes at half their t (face 12,345),
    a quarter at their t with the face id one below (the seed wins the
    tie), a quarter one above (the face wins)."""
    ts, fs = _open_seeds(seed)
    k = np.flatnonzero(_case(seed)[4] & (f > 0))
    ts[k[0::4]], fs[k[0::4]] = t[k[0::4]] * np.float32(0.5), 12_345
    ts[k[1::4]], fs[k[1::4]] = t[k[1::4]], f[k[1::4]] - 1
    ts[k[2::4]], fs[k[2::4]] = t[k[2::4]], f[k[2::4]] + 1
    return ts, fs


def _any_hit_seeds(seed):
    """t_limit around each ray's nearest t (plain pass), a fifth of the
    lanes seeded occluded."""
    rng = np.random.default_rng(seed + 1)
    t = _plain(seed, None, *_open_seeds(seed))[0].numpy()
    t_limit = np.where(np.isfinite(t) & (t > 0), t * rng.uniform(0.5, 1.5, N_RAYS), 2.0)
    occ = (rng.random(N_RAYS) < 0.2).astype(np.float32)
    return t_limit.astype(np.float32), occ


def _plain(seed, t_limit, seed_t, seed_f):
    o, d, lin, words, _ = _case(seed)
    ov, dv = Vec3(*map(torch.tensor, o)), Vec3(*map(torch.tensor, d))
    lin_fm = torch.tensor(lin).transpose(1, 2).contiguous().transpose(1, 2)
    return cs._masked_plain(ov, dv, None if t_limit is None else torch.tensor(t_limit),
                            lin_fm, torch.tensor(words), torch.tensor(seed_t),
                            None if seed_f is None else torch.tensor(seed_f))


def _jax(seed, t_limit, seed_t, seed_f):
    o, d, lin, words, _ = _case(seed)
    n_tiles = N_RAYS // cs.TILE
    c = np.stack([o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                  o[0] * d[1] - o[1] * d[0]])
    tl = np.zeros(N_RAYS, np.float32) if t_limit is None else t_limit
    cols = np.concatenate([o, d, c, tl[None], np.zeros((6, N_RAYS), np.float32)])
    rays = jnp.asarray(cols.T.reshape(n_tiles, cs.TILE, jax_sweep.RCOLS))
    call = jax_sweep._build_call_masked(lin.shape[0], cs.LIN, cs.TILE, cs.GROUPS, n_tiles,
                                        t_limit is not None, interpret=True)
    t_out, f_out = call(jnp.asarray(words), jnp.asarray(lin), rays,
                        jnp.asarray(seed_t.reshape(n_tiles, cs.TILE, 1)),
                        jnp.asarray(seed_f.reshape(n_tiles, cs.TILE, 1)))
    return np.asarray(t_out).reshape(-1), np.asarray(f_out).reshape(-1)


@pytest.mark.parametrize("seed", [5, 9])
def test_masked_plain_matches_kernel_masked_rows_nearest(seed):
    """Nearest, with open seeds and then with seeds that win or tie (each
    side's seeds from its own open pass: a ULP of t decides a tie): faces
    equal on every lane, t close; the tie face wins over its copies in
    another chunk and another lin cluster; the seeds that win stay; the
    gated-off row keeps its seeds."""
    t_open, f_open = (x.numpy() for x in _plain(seed, None, *_open_seeds(seed)))
    t_jopen, f_jopen = _jax(seed, None, *_open_seeds(seed))
    np.testing.assert_array_equal(f_open, f_jopen)
    # Rows 0 and 1 of tile 0 run both lin clusters that hold the tie: the
    # tie face wins, never its copies (face 40, face 133).
    assert (f_open[:64] == TIE_FACE).sum() >= 30
    assert not np.isin(f_open[:64], [40, cs.LIN + 5]).any()
    ts, fs = _win_seeds(seed, t_open, f_open)
    t, f = (x.numpy() for x in _plain(seed, None, ts, fs))
    t_ref, f_ref = _jax(seed, None, *_win_seeds(seed, t_jopen, f_jopen))
    np.testing.assert_array_equal(f, f_ref)
    for a, b in ((t_open, t_jopen), (t, t_ref)):
        fin = np.isfinite(b) & (b > BIG_NEG)
        np.testing.assert_array_equal(a[~fin], b[~fin])
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=1e-5)
    assert (f == 12_345).sum() > 10
    k = np.flatnonzero(_case(seed)[4] & (f_open > 0))
    np.testing.assert_array_equal(f[k[1::4]], f_open[k[1::4]] - 1)
    np.testing.assert_array_equal(f[k[2::4]], f_open[k[2::4]])
    row7 = (np.arange(N_RAYS) // cs.ROW) % cs.GROUPS == 7
    np.testing.assert_array_equal(f[row7], fs[row7])


@pytest.mark.parametrize("seed", [5, 9])
def test_masked_plain_matches_kernel_masked_rows_any_hit(seed):
    """Any-hit: the occlusion bit equal on every lane, occluded seeds
    kept."""
    t_limit, occ_seed = _any_hit_seeds(seed)
    occ = _plain(seed, t_limit, occ_seed, None).numpy()
    occ_ref, _ = _jax(seed, t_limit, occ_seed, _open_seeds(seed)[1])
    np.testing.assert_array_equal(occ, occ_ref)
    assert (occ[occ_seed > 0] == 1).all() and 0 < (occ > occ_seed).sum()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 9])
@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any-hit"])
def test_masked_kernel_matches_plain_on_card(seed, any_hit):
    """K5m against its plain version on the card, bitwise, on the crafted
    passes and on them repeated 64 times over (32,768 rays, 128 tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernel K5m has no CPU mode")
    o, d, lin, words, _ = _case(seed)
    if any_hit:
        (t_limit, seed_t), seed_f = _any_hit_seeds(seed), None
    else:
        t_open, f_open = (x.numpy() for x in _plain(seed, None, *_open_seeds(seed)))
        t_limit, (seed_t, seed_f) = None, _win_seeds(seed, t_open, f_open)
    for reps in (1, 64):
        rep = lambda a: None if a is None else torch.tensor(  # noqa: E731
            np.tile(a, reps) if a.ndim == 1 else np.tile(a, (1, reps)), device="cuda")
        ov, dv = Vec3(*(rep(c) for c in o)), Vec3(*(rep(c) for c in d))
        lin_fm = torch.tensor(lin, device="cuda").transpose(1, 2).contiguous().transpose(1, 2)
        w = torch.tensor(np.tile(words, (reps, 1)), device="cuda")
        args = (ov, dv, rep(t_limit), lin_fm, w, rep(seed_t), rep(seed_f))
        got, ref = cs._masked_kernel(*args), cs._masked_plain(*args)
        torch.cuda.synchronize()
        got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
