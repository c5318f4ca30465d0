"""Kernel K5's inputs as the card reads them (pbr_tpu_torch/ops/cuda_sweep.py,
pbr_tpu_torch/scene/device.py), on the CPU: the face-major lin table that
``to_torch`` builds once a scene, which K5, K5m and their plain versions
read, and K5's tile order, heaviest first.

Everything here is held exact: the table is a transposed copy of the host
tables, and the plain sweep's answers and counters do not depend on the
order of the tiles or on the layout of the table it reads. The kernels run
only on a card (``tests/test_torch_row_sweep.py``'s ``cuda``-marked test);
tests/test_torch_row_sweep.py holds the plain versions to JAX's
interpret-mode ``intersect_sweep`` on the face-major table.
"""

import functools

import numpy as np
import pytest
import torch

from pbr_tpu_torch import to_torch
from pbr_tpu_torch.ops import cuda_sweep as cs
from pbr_tpu_torch.ops.vec import Vec3
from pbr_tpu_torch.scene.build import scene_from_text
from pbr_tpu_torch.scene.procedural import grey_soup, multi_room

torch.set_num_threads(1)

LIGHT = (0.0, 2.4, 0.0)  # bench.py's soup orb


@functools.lru_cache(maxsize=None)
def _scene(name):
    """soup: bench.py's soup at 13,000 faces (102 lin clusters, so K5 with
    the sort and the row early-out); multiroom: bench.py's rooms (16 lin
    clusters, K5m)."""
    scene, _ = scene_from_text(*(grey_soup(13_000) if name == "soup" else multi_room()),
                               use_bvh=True)
    return scene


def _camera_rays(n, seed):
    """A narrow cone from the soup's eye (0, 0, 3.5) towards -z."""
    rs = np.random.RandomState(seed)
    o = np.stack([rs.uniform(-0.05, 0.05, n), rs.uniform(-0.05, 0.05, n), np.full(n, 3.5)])
    d = np.stack([rs.uniform(-0.3, 0.3, n), rs.uniform(-0.3, 0.3, n), -np.ones(n)])
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (Vec3(*(torch.tensor(c, dtype=torch.float32) for c in o)),
            Vec3(*(torch.tensor(c, dtype=torch.float32) for c in d)))


@pytest.mark.parametrize("name", ["soup", "multiroom"])
def test_face_major_table_is_lin_transposed(name):
    """``clu_lin_fm`` is the host lin tables transposed to (CL, 128, 16),
    contiguous and bitwise equal; ``clusters.lin`` is its (CL, 16, 128)
    view, equal to the host tables, and no second copy is kept."""
    scene = _scene(name)
    ts = to_torch(scene, "cpu")
    host = scene.clusters.lin
    fm = ts.clu_lin_fm
    assert fm.dtype == torch.float32 and fm.is_contiguous()
    assert fm.shape == (host.shape[0], cs.LIN, 16)
    np.testing.assert_array_equal(fm.numpy(), host.transpose(0, 2, 1))
    lin = ts.clusters.lin
    assert lin.shape == host.shape and lin.data_ptr() == fm.data_ptr()
    np.testing.assert_array_equal(lin.numpy(), host)
    assert "clu_lin" not in dict(ts.named_buffers())


def test_kernels_take_only_the_face_major_table():
    """The wrapper's check passes ``to_torch``'s view and refuses the same
    values stored row-major, which the kernels would misread."""
    clusters = to_torch(_scene("multiroom"), "cpu").clusters
    assert cs._check_lin(clusters, torch.device("cpu")) is clusters.lin
    with pytest.raises(ValueError, match="face-major"):
        cs._check_lin(clusters._replace(lin=clusters.lin.contiguous()), torch.device("cpu"))


def test_row_order_is_most_listed_pairs_first_ties_ascending():
    """The tiles by listed (row, slot) pairs: the row bits (16-23) of the
    slots within ``cnt`` counted, most first, equal counts in ascending
    tile order; the lin ids (bits 0-15) and slots past ``cnt`` do not
    count."""
    rs = np.random.RandomState(4)
    n_tiles, n_lin = 97, 40
    cand = rs.randint(0, 1 << 24, size=(n_tiles, n_lin)).astype(np.int32)
    cnt = rs.randint(0, n_lin + 1, size=n_tiles).astype(np.int32)
    cand[10:20] = cand[10]  # ten tiles with equal lists
    cnt[10:20] = cnt[10]
    listed = np.array([sum(bin((int(c) >> 16) & 0xFF).count("1") for c in cand[t, :cnt[t]])
                       for t in range(n_tiles)])
    order = cs.row_order(torch.tensor(cand), torch.tensor(cnt))
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.argsort(-listed, kind="stable"))
    got = listed[order.numpy()]
    assert (np.diff(got) <= 0).all()
    ties = [t for t in order.tolist() if 10 <= t < 20]
    assert ties == list(range(10, 20))


def _recorded_passes(o, d, clusters, light):
    """The sweep wrapper's passes with the plain versions in the kernels'
    places: each pass's plain version, arguments and outputs."""
    passes = []

    def recorder(plain):
        def run(*args):
            out = plain(*args)
            passes.append((plain, args, out))
            return out
        return run

    cs._sweep(recorder(cs._slotted_plain), recorder(cs._masked_plain), o, d, clusters, light,
              None, False)
    return passes


@pytest.mark.parametrize("name", ["soup", "multiroom"])
def test_plain_sweeps_read_either_layout_alike(name):
    """Each pass of the plain K5 (soup) or K5m (multiroom), nearest and
    any-hit, replayed on a row-major copy of the same table: outputs
    bitwise equal to those on the face-major view."""
    clusters = to_torch(_scene(name), "cpu").clusters
    o, d = _camera_rays(768, 3)
    if name == "multiroom":  # from inside the rooms
        o = Vec3(o.x, o.y + 1.0, o.z - 0.5)
    passes = _recorded_passes(o, d, clusters, Vec3(*(torch.tensor(v) for v in LIGHT)))
    assert [p[0] for p in passes] == [cs._slotted_plain if name == "soup" else
                                      cs._masked_plain] * 2
    for plain, args, out in passes:
        row_major = args[3].contiguous()
        assert not torch.equal(row_major.view(-1), args[3].transpose(1, 2).reshape(-1))
        got = plain(*args[:3], row_major, *args[4:])
        for x, y in zip(got if isinstance(got, tuple) else (got,),
                        out if isinstance(out, tuple) else (out,)):
            assert torch.equal(x, y)
    assert (passes[0][2][1] >= 0).float().mean() > 0.3  # the case has substance


def _tiles(a, perm, per_tile):
    """``a``'s tile-major rows regrouped in the tile order ``perm``."""
    return a.reshape(perm.shape[0], per_tile, *a.shape[1:])[perm].reshape(a.shape)


@pytest.mark.parametrize("pass_index", [0, 1], ids=["nearest", "any-hit"])
def test_permuted_tile_order_changes_no_answer(pass_index):
    """Each K5 pass of the soup case swept with its tiles in another order
    (heaviest first, as K5's blocks take them, and reversed), then put back:
    its outputs and its executed (row, slot) pairs equal the pass in launch
    order."""
    clusters = to_torch(_scene("soup"), "cpu").clusters
    o, d = _camera_rays(16 * cs.TILE, 8)
    _, args, ref = _recorded_passes(o, d, clusters, Vec3(*(torch.tensor(v) for v in LIGHT)))[
        pass_index]
    ref = ref if isinstance(ref, tuple) else (ref,)
    o_p, d_p, t_limit, lin, cand, cnt, tent, early_out, seed_t, seed_f = args
    assert early_out and (t_limit is not None) == (pass_index == 1)
    n_tiles = cand.shape[0]
    work_ref = []
    cs._slotted_plain(*args, work=work_ref)
    heaviest = cs.row_order(cand, cnt).long()
    assert not torch.equal(heaviest, torch.arange(n_tiles))
    for perm in (heaviest, torch.arange(n_tiles - 1, -1, -1)):
        per_ray = lambda a: None if a is None else _tiles(a, perm, cs.TILE)  # noqa: E731
        work = []
        out = cs._slotted_plain(
            Vec3(*map(per_ray, o_p)), Vec3(*map(per_ray, d_p)), per_ray(t_limit), lin,
            cand[perm], cnt[perm], tent[perm], early_out, per_ray(seed_t), per_ray(seed_f),
            work=work)
        out = out if isinstance(out, tuple) else (out,)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n_tiles)
        for x, y in zip(out, ref):
            assert torch.equal(_tiles(x, inv, cs.TILE), y)
        assert sum(r.numel() for r, _ in work) == sum(r.numel() for r, _ in work_ref)
