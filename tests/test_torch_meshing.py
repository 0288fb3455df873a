"""Mesh export and track triangulation of the port vs the JAX package:
ops/meshing.py (the tet table, `extract_mesh`, `save_obj`),
`DenseSLAM.save_mesh`, and ops/reconstruction.py `triangulate_tracks`.

The map: tests/test_meshing.py's (`tiny_test_config`, 80x60, 4 frames of
the default scene fused by JAX), carried to the port by io/convert.py.
Tolerances, and why:
  * the tet and edge tables equal;
  * the triangle soup: the same triangles in the same order, vertices
    within 1e-6 m (the jitted JAX interpolation contracts its
    multiply-add into an FMA); its OBJ file byte for byte JAX's, written
    from the same triangles;
  * triangulation: validity equal; on the valid tracks points within
    1e-4 m and reprojection RMSEs within 1e-3 px (the DLT start and the
    Gauss-Newton normal equations are float32 sums in another order; 5
    steps of GN damp the difference). An invalid track may differ: the
    normal equations of a track seen once, at a camera centre, overflow
    float32 in the port's 3x3 inverse (NaN) and not under XLA's dot.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.ops import meshing as jmesh
from denseslam_tpu.ops import reconstruction as jrec
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import meshing as pmesh
from denseslam_tpu_torch.ops import reconstruction as prec
from denseslam_tpu_torch.ops import tsdf as pt


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one thread each spares the other
    test processes of a parallel run the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fused():
    """tests/test_meshing.py's map: 4 frames of the default scene fused by
    JAX; the JAX map and the port's copy of it."""
    cfg = tiny_test_config()
    m = jt.make_map(cfg.tsdf)
    poses = js.make_trajectory(4, step_m=0.06, yaw_rate=0.0)

    @jax.jit
    def fuse(m, depth, T):
        m, slots, mask = jt.allocate_for_frame(m, depth, T, cfg.rig.intr,
                                               cfg.tsdf)
        m = jt.integrate(m, slots, mask, depth, None, T, cfg.rig.intr,
                         cfg.tsdf)
        return jt.advance_frame(m)

    for i in range(4):
        T = jnp.asarray(poses[i])
        _, depth = js.render_view(T, cfg.rig.intr)
        m = fuse(m, depth, T)
    mp = convert.map_state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(m)], device="cpu")
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    return cfg, pcfg, m, mp, jmesh.extract_mesh(m, cfg.tsdf)


def test_tet_and_edge_tables_match_jax():
    np.testing.assert_array_equal(pmesh._TETS, jmesh._TETS)
    np.testing.assert_array_equal(pmesh._CUBE_OFFSETS, jmesh._CUBE_OFFSETS)
    np.testing.assert_array_equal(pmesh._EDGE_TABLE, jmesh._EDGE_TABLE)


@pytest.mark.parametrize("chunk", [512, 7])
def test_extract_mesh_matches_jax(fused, chunk):
    """The port's soup, meshed 512 blocks a chunk (JAX's) and 7 (ragged
    chunks), equals JAX's in order within 1e-6 m."""
    _, pcfg, _, mp, want = fused
    got = pmesh.extract_mesh(mp, pcfg.tsdf, chunk=chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] > 500
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mesh_lies_on_the_scene(fused):
    """tests/test_meshing.py's bounds on the port's mesh: vertices within
    5 cm of a scene surface (median) and 12 cm (95%), edges under two
    voxels."""
    cfg, pcfg, _, mp, _ = fused
    tris = pmesh.extract_mesh(mp, pcfg.tsdf)
    scene = js.default_scene()
    v = tris.reshape(-1, 3)
    dists = [np.abs(np.linalg.norm(v - c, axis=-1) - r) for c, r in
             zip(np.asarray(scene.sphere_centers),
                 np.asarray(scene.sphere_radii))]
    dists += [np.abs(v[:, 1] - scene.plane_y), np.abs(v[:, 2] - scene.wall_z)]
    d = np.min(np.stack(dists), axis=0)
    assert np.median(d) < 0.05 and np.quantile(d, 0.95) < 0.12
    e = np.linalg.norm(tris[:, [1, 2, 0]] - tris, axis=-1)
    assert e.max() < cfg.tsdf.voxel_size_m * 2.0


def test_empty_map_has_no_triangles():
    cfg = convert.config_from_dict(dataclasses.asdict(tiny_test_config()))
    m = pt.make_map(cfg.tsdf, device="cpu")
    tris = pmesh.extract_mesh(m, cfg.tsdf)
    assert tris.shape == (0, 3, 3)


def test_save_obj_is_byte_identical(fused, tmp_path):
    """The same triangles give JAX's file byte for byte, the empty soup
    too."""
    _, _, _, _, tris = fused
    for name, t in (("scene", tris), ("empty", tris[:0])):
        a, b = tmp_path / f"{name}_jax.obj", tmp_path / f"{name}_port.obj"
        jmesh.save_obj(str(a), t)
        pmesh.save_obj(str(b), t)
        assert a.read_bytes() == b.read_bytes()
    text = (tmp_path / "scene_port.obj").read_text().splitlines()
    assert sum(1 for ln in text if ln.startswith("f ")) == tris.shape[0]


def test_dense_slam_save_mesh(fused, tmp_path):
    """DenseSLAM.save_mesh meshes the active submap (here the fused map)
    and returns the triangle count, JAX's for that map. (The vertex count
    after the 0.1 mm dedupe may differ by a few: vertices within 1e-6 m
    can round to neighbouring grid cells.)"""
    _, pcfg, _, mp, want = fused
    slam = pd.DenseSLAM(pcfg, device="cpu")
    slam.submaps.active = mp
    path = tmp_path / "map.obj"
    assert slam.save_mesh(str(path)) == want.shape[0] > 500
    text = path.read_text().splitlines()
    assert text[0].endswith(f" {want.shape[0]} tris")
    assert sum(1 for ln in text if ln.startswith("f ")) == want.shape[0]


def _tracks(seed, noise_px, n_pts=64, n_frames=5):
    """tests/test_reconstruction.py `make_tracks`: random points seen from
    5 poses a fixed twist apart, with pixel noise."""
    rng = np.random.default_rng(seed)
    intr = tiny_test_config(width=320, height=240).rig.intr
    pts = rng.uniform([-2, -1.5, 3.0], [2, 1.5, 9.0],
                      (n_pts, 3)).astype(np.float32)
    step = np.asarray(jl.se3_exp(jnp.asarray(
        [0.15, 0.02, 0.1, 0.0, 0.01, 0.0], jnp.float32)))
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n_frames - 1):
        poses.append(poses[-1] @ step)
    poses = np.stack(poses)
    uv = np.zeros((n_pts, n_frames, 2), np.float32)
    mask = np.zeros((n_pts, n_frames), bool)
    for k in range(n_frames):
        Ti = np.asarray(jl.inv_T(jnp.asarray(poses[k])))
        pc = pts @ Ti[:3, :3].T + Ti[:3, 3]
        u = pc[:, 0] / pc[:, 2] * intr.fx + intr.cx
        v = pc[:, 1] / pc[:, 2] * intr.fy + intr.cy
        mask[:, k] = ((pc[:, 2] > 0.5) & (u > 0) & (u < intr.width)
                      & (v > 0) & (v < intr.height))
        uv[:, k, 0] = u + rng.normal(0, noise_px, n_pts)
        uv[:, k, 1] = v + rng.normal(0, noise_px, n_pts)
    return intr, uv, mask, poses, pts


@pytest.mark.parametrize("case", ["exact", "noisy", "short"])
def test_triangulate_tracks_matches_jax(case):
    intr, uv, mask, poses, pts = _tracks(0, 0.5 if case == "noisy" else 0.0)
    if case == "short":
        mask[:10, 1:] = False        # single-observation tracks
    want = jrec.triangulate_tracks(
        jrec.Tracks(jnp.asarray(uv), jnp.asarray(mask), jnp.asarray(poses)),
        intr)
    got = prec.triangulate_tracks(
        prec.Tracks(torch.tensor(uv), torch.tensor(mask),
                    torch.tensor(poses)), intr)
    v = got.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(want.valid))
    np.testing.assert_allclose(got.points_w.numpy()[v],
                               np.asarray(want.points_w)[v], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.reproj_rmse.numpy()[v],
                               np.asarray(want.reproj_rmse)[v], rtol=0,
                               atol=1e-3)
    err = np.linalg.norm(got.points_w.numpy()[v] - pts[v], axis=-1)
    assert v.sum() > 40
    assert np.median(err) < (0.15 if case == "noisy" else 0.01)
    if case == "short":
        assert not v[:10].any()
